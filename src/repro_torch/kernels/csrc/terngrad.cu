// TernGrad ternarization for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/terngrad.py::terngrad_2d (_tern_kernel):
//   p = |x| * inv_smax;  b = [u < p];  code = sign(x) * b
// written as int8 in {-1, 0, +1}.  inv_smax = 1 / max(max|x|, 1e-30) is
// computed by the wrapper and read here from device memory (no host round
// trip).  The comparison is strict, so u == p gives 0; -0.0 and +0.0 give 0.
//
// Bound: bytes.  Per element it reads x and u (4 + 4 B) and writes the code
// (1 B): 9 B/element against three f32 operations.  Design: one thread per 4
// elements, float4 loads and a char4 store (neighbouring threads on
// neighbouring addresses), a masked scalar tail, 64-bit offsets.  No padding
// to the TPU's (256, 128) tiles: the grid masks its own tail.
//
// The product is a round-to-nearest intrinsic and the file is built with
// --fmad=false, so the codes equal the plain PyTorch version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ signed char tern_one(float x, float u, float inv) {
  const int b = u < __fmul_rn(fabsf(x), inv);
  return static_cast<signed char>(x > 0.0f ? b : (x < 0.0f ? -b : 0));
}

__global__ void terngrad_kernel(const float* __restrict__ x, const float* __restrict__ u,
                                const float* __restrict__ inv_ptr,
                                signed char* __restrict__ out, long long n, int vec) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = q * 4;
  if (i >= n) return;
  const float inv = __ldg(inv_ptr);
  if (vec && i + 4 <= n) {
    const float4 xv = reinterpret_cast<const float4*>(x)[q];
    const float4 uv = reinterpret_cast<const float4*>(u)[q];
    char4 c;
    c.x = tern_one(xv.x, uv.x, inv);
    c.y = tern_one(xv.y, uv.y, inv);
    c.z = tern_one(xv.z, uv.z, inv);
    c.w = tern_one(xv.w, uv.w, inv);
    reinterpret_cast<char4*>(out)[q] = c;
  } else {
    for (long long k = i; k < n && k < i + 4; ++k) out[k] = tern_one(x[k], u[k], inv);
  }
}

// The row-batched form (terngrad_2d under jax.vmap): a contiguous (rows, n)
// stack, each row with its own inv_smax read from device memory.  Element i
// belongs to row i / n; when n % 4 == 0 a thread's 4 elements share a row
// and move as a float4 / char4.  The element arithmetic is tern_one's.
__global__ void terngrad_rows_kernel(const float* __restrict__ x, const float* __restrict__ u,
                                     const float* __restrict__ inv,
                                     signed char* __restrict__ out, long long total, long long n,
                                     int vec) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = q * 4;
  if (i >= total) return;
  if (vec && i + 4 <= total) {
    const float r_inv = __ldg(inv + i / n);
    const float4 xv = reinterpret_cast<const float4*>(x)[q];
    const float4 uv = reinterpret_cast<const float4*>(u)[q];
    char4 c;
    c.x = tern_one(xv.x, uv.x, r_inv);
    c.y = tern_one(xv.y, uv.y, r_inv);
    c.z = tern_one(xv.z, uv.z, r_inv);
    c.w = tern_one(xv.w, uv.w, r_inv);
    reinterpret_cast<char4*>(out)[q] = c;
  } else {
    for (long long k = i; k < total && k < i + 4; ++k)
      out[k] = tern_one(x[k], u[k], __ldg(inv + k / n));
  }
}

}  // namespace

extern "C" int terngrad_launch(const float* x, const float* u, const float* inv,
                               signed char* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  const int threads = 256;
  const long long quads = (n + 3) / 4;
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  terngrad_kernel<<<blocks, threads, 0, stream>>>(x, u, inv, out, n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int terngrad_rows_launch(const float* x, const float* u, const float* inv,
                                    signed char* out, long long rows, long long n,
                                    cudaStream_t stream) {
  const long long total = rows * n;
  if (total <= 0) return 0;
  const int vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  const int threads = 256;
  const long long quads = (total + 3) / 4;
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  terngrad_rows_kernel<<<blocks, threads, 0, stream>>>(x, u, inv, out, total, n, vec);
  return static_cast<int>(cudaGetLastError());
}
