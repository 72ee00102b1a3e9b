// Fused error feedback + QSGD quantization for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/qsgd_ef.py::qsgd_ef_2d (_qsgd_ef_kernel):
//   a = e * decay + g;  code = Q(a) as in qsgd.cu;  e' = a - code / levels / max(inv, 1e-38)
// inv = 1/||e*decay + g|| comes from the wrapper in device memory; levels and
// decay are runtime scalars.  e' may be written over e (each thread reads its
// elements before it writes them), which is how the trainer keeps one
// residual buffer per worker and bucket.
//
// Bound: bytes.  It reads g, e and u (12 B) and writes the code and e'
// (1 + 4 B): 17 B/element.  Design: one thread per 4 elements, float4 loads,
// a char4 and a float4 store, a masked scalar tail, 64-bit offsets.
//
// e * decay + g must not become one fused multiply-add (the plain version
// rounds twice, and a different a can move a code across a dither boundary):
// every operation is a round-to-nearest intrinsic and the file is built with
// --fmad=false.  The two divisions stay IEEE-correct: no fast-math flags.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void qsgd_ef_one(float g, float e, float u, float inv, float levels,
                                            float decay, signed char* code_out, float* e_out) {
  const float a = __fadd_rn(__fmul_rn(e, decay), g);
  const float y = __fmul_rn(__fmul_rn(fabsf(a), inv), levels);
  float l = floorf(y);
  l = __fadd_rn(l, (u < __fsub_rn(y, l)) ? 1.0f : 0.0f);
  const float s = (a > 0.0f) ? 1.0f : ((a < 0.0f) ? -1.0f : 0.0f);
  const float code = __fmul_rn(s, l);
  *code_out = static_cast<signed char>(static_cast<int>(code));
  const float deq = __fdiv_rn(__fdiv_rn(code, levels), fmaxf(inv, 1e-38f));
  *e_out = __fsub_rn(a, deq);
}

__global__ void qsgd_ef_kernel(const float* __restrict__ g, const float* e,
                               const float* __restrict__ u, const float* __restrict__ inv_ptr,
                               float levels, float decay, signed char* __restrict__ codes,
                               float* e_out, long long n, int vec) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = q * 4;
  if (i >= n) return;
  const float inv = __ldg(inv_ptr);
  if (vec && i + 4 <= n) {
    const float4 gv = reinterpret_cast<const float4*>(g)[q];
    const float4 ev = reinterpret_cast<const float4*>(e)[q];
    const float4 uv = reinterpret_cast<const float4*>(u)[q];
    char4 c;
    float4 en;
    qsgd_ef_one(gv.x, ev.x, uv.x, inv, levels, decay, &c.x, &en.x);
    qsgd_ef_one(gv.y, ev.y, uv.y, inv, levels, decay, &c.y, &en.y);
    qsgd_ef_one(gv.z, ev.z, uv.z, inv, levels, decay, &c.z, &en.z);
    qsgd_ef_one(gv.w, ev.w, uv.w, inv, levels, decay, &c.w, &en.w);
    reinterpret_cast<char4*>(codes)[q] = c;
    reinterpret_cast<float4*>(e_out)[q] = en;
  } else {
    for (long long k = i; k < n && k < i + 4; ++k) {
      signed char c;
      float en;
      qsgd_ef_one(g[k], e[k], u[k], inv, levels, decay, &c, &en);
      codes[k] = c;
      e_out[k] = en;
    }
  }
}

// The row-batched form (qsgd_ef_2d under jax.vmap): a contiguous (rows, n)
// stack, each row with its own inv and levels read from device memory, one
// decay for all.  Element i belongs to row i / n; when n % 4 == 0 a
// thread's 4 elements share a row and move as float4s.  The element
// arithmetic is qsgd_ef_one's; e' may be written over e.
__global__ void qsgd_ef_rows_kernel(const float* __restrict__ g, const float* e,
                                    const float* __restrict__ u, const float* __restrict__ inv,
                                    const float* __restrict__ levels, float decay,
                                    signed char* __restrict__ codes, float* e_out,
                                    long long total, long long n, int vec) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = q * 4;
  if (i >= total) return;
  if (vec && i + 4 <= total) {
    const long long row = i / n;
    const float r_inv = __ldg(inv + row), r_lv = __ldg(levels + row);
    const float4 gv = reinterpret_cast<const float4*>(g)[q];
    const float4 ev = reinterpret_cast<const float4*>(e)[q];
    const float4 uv = reinterpret_cast<const float4*>(u)[q];
    char4 c;
    float4 en;
    qsgd_ef_one(gv.x, ev.x, uv.x, r_inv, r_lv, decay, &c.x, &en.x);
    qsgd_ef_one(gv.y, ev.y, uv.y, r_inv, r_lv, decay, &c.y, &en.y);
    qsgd_ef_one(gv.z, ev.z, uv.z, r_inv, r_lv, decay, &c.z, &en.z);
    qsgd_ef_one(gv.w, ev.w, uv.w, r_inv, r_lv, decay, &c.w, &en.w);
    reinterpret_cast<char4*>(codes)[q] = c;
    reinterpret_cast<float4*>(e_out)[q] = en;
  } else {
    for (long long k = i; k < total && k < i + 4; ++k) {
      const long long row = k / n;
      signed char c;
      float en;
      qsgd_ef_one(g[k], e[k], u[k], __ldg(inv + row), __ldg(levels + row), decay, &c, &en);
      codes[k] = c;
      e_out[k] = en;
    }
  }
}

}  // namespace

extern "C" int qsgd_ef_launch(const float* g, const float* e, const float* u, const float* inv,
                              float levels, float decay, signed char* codes, float* e_out,
                              long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(e) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(e_out) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(codes) % 4 == 0);
  const int threads = 256;
  const long long quads = (n + 3) / 4;
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  qsgd_ef_kernel<<<blocks, threads, 0, stream>>>(g, e, u, inv, levels, decay, codes, e_out, n,
                                                 vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qsgd_ef_rows_launch(const float* g, const float* e, const float* u,
                                   const float* inv, const float* levels, float decay,
                                   signed char* codes, float* e_out, long long rows, long long n,
                                   cudaStream_t stream) {
  const long long total = rows * n;
  if (total <= 0) return 0;
  const int vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(e) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(u) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(e_out) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(codes) % 4 == 0);
  const int threads = 256;
  const long long quads = (total + 3) / 4;
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  qsgd_ef_rows_kernel<<<blocks, threads, 0, stream>>>(g, e, u, inv, levels, decay, codes, e_out,
                                                      total, n, vec);
  return static_cast<int>(cudaGetLastError());
}
