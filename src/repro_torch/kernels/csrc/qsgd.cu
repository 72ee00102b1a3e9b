// QSGD stochastic quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/qsgd.py::qsgd_2d (_qsgd_kernel):
//   y = |x| * inv * levels;  l = floor(y) + [u < y - floor(y)];  code = sign(x) * l
// written as int8.  inv = 1/||x|| is computed by the wrapper and read here
// from device memory (no host round trip); levels is a runtime scalar.
//
// Bound: bytes.  Per element it reads x and u (4 + 4 B) and writes the code
// (1 B): 9 B/element, a handful of f32 operations per element.  Design: one
// thread per 4 elements, float4 loads and a char4 store (16 B / 4 B per
// thread, neighbouring threads on neighbouring addresses), a masked scalar
// tail, 64-bit offsets.  No padding to the TPU's (rows, 128) tiles.
//
// Every operation is a round-to-nearest intrinsic and the file is built with
// --fmad=false, so the codes equal the plain PyTorch version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ signed char qsgd_one(float x, float u, float inv, float levels) {
  const float y = __fmul_rn(__fmul_rn(fabsf(x), inv), levels);
  float l = floorf(y);
  l = __fadd_rn(l, (u < __fsub_rn(y, l)) ? 1.0f : 0.0f);
  const float s = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  return static_cast<signed char>(static_cast<int>(__fmul_rn(s, l)));
}

__global__ void qsgd_kernel(const float* __restrict__ x, const float* __restrict__ u,
                            const float* __restrict__ inv_ptr, float levels,
                            signed char* __restrict__ out, long long n, int vec) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = q * 4;
  if (i >= n) return;
  const float inv = __ldg(inv_ptr);
  if (vec && i + 4 <= n) {
    const float4 xv = reinterpret_cast<const float4*>(x)[q];
    const float4 uv = reinterpret_cast<const float4*>(u)[q];
    char4 c;
    c.x = qsgd_one(xv.x, uv.x, inv, levels);
    c.y = qsgd_one(xv.y, uv.y, inv, levels);
    c.z = qsgd_one(xv.z, uv.z, inv, levels);
    c.w = qsgd_one(xv.w, uv.w, inv, levels);
    reinterpret_cast<char4*>(out)[q] = c;
  } else {
    for (long long k = i; k < n && k < i + 4; ++k) out[k] = qsgd_one(x[k], u[k], inv, levels);
  }
}

// The row-batched form (the counterpart of qsgd_2d under jax.vmap, whose
// batching rule adds a grid axis): a contiguous (rows, n) stack, each row
// with its own inv and levels read from device memory.  The B*n elements
// are flattened and element i belongs to row i / n; when n % 4 == 0 a
// thread's 4 elements share a row and move as a float4 / char4, otherwise
// each element finds its own row.  The element arithmetic is qsgd_one's.
__global__ void qsgd_rows_kernel(const float* __restrict__ x, const float* __restrict__ u,
                                 const float* __restrict__ inv, const float* __restrict__ levels,
                                 signed char* __restrict__ out, long long total, long long n,
                                 int vec) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = q * 4;
  if (i >= total) return;
  if (vec && i + 4 <= total) {
    const long long row = i / n;
    const float r_inv = __ldg(inv + row), r_lv = __ldg(levels + row);
    const float4 xv = reinterpret_cast<const float4*>(x)[q];
    const float4 uv = reinterpret_cast<const float4*>(u)[q];
    char4 c;
    c.x = qsgd_one(xv.x, uv.x, r_inv, r_lv);
    c.y = qsgd_one(xv.y, uv.y, r_inv, r_lv);
    c.z = qsgd_one(xv.z, uv.z, r_inv, r_lv);
    c.w = qsgd_one(xv.w, uv.w, r_inv, r_lv);
    reinterpret_cast<char4*>(out)[q] = c;
  } else {
    for (long long k = i; k < total && k < i + 4; ++k) {
      const long long row = k / n;
      out[k] = qsgd_one(x[k], u[k], __ldg(inv + row), __ldg(levels + row));
    }
  }
}

}  // namespace

extern "C" int qsgd_launch(const float* x, const float* u, const float* inv, float levels,
                           signed char* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  const int threads = 256;
  const long long quads = (n + 3) / 4;
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  qsgd_kernel<<<blocks, threads, 0, stream>>>(x, u, inv, levels, out, n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_rows_launch(const float* x, const float* u, const float* inv,
                                const float* levels, signed char* out, long long rows,
                                long long n, cudaStream_t stream) {
  const long long total = rows * n;
  if (total <= 0) return 0;
  const int vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  const int threads = 256;
  const long long quads = (total + 3) / 4;
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  qsgd_rows_kernel<<<blocks, threads, 0, stream>>>(x, u, inv, levels, out, total, n, vec);
  return static_cast<int>(cudaGetLastError());
}
