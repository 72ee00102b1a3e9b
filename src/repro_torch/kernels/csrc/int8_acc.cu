// Widening int8 accumulate over gathered quantizer codes, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wire_reduce.py::int8_acc_3d
// (_int8_acc_kernel):  out[i] = sum_w weights[w] * codes[w][i]  in f32, where
// weights[w] = norm_w / levels (times a participation mask, where there is
// one).  The (W, n) f32 decode never exists in device memory.
//
// Bound: bytes.  It reads W int8 codes and writes one f32 per element:
// (W + 4) B/element.  Design: one thread per 4 elements; for w = 0..W-1 in
// order it loads a char4 of row w and adds weight * code in f32 (one rounding
// for the product, one for the sum, as the plain version does).  The (W,)
// weights sit in shared memory.  Rows may be padded: row w starts at
// codes + w * ld.  A masked scalar tail, 64-bit offsets; W rows of 155M
// elements reach 2^31 at W = 14.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void int8_acc_kernel(const signed char* __restrict__ codes, long long ld,
                                const float* __restrict__ weights, int n_w,
                                float* __restrict__ out, long long n, int vec) {
  extern __shared__ float sw[];
  for (int k = threadIdx.x; k < n_w; k += blockDim.x) sw[k] = weights[k];
  __syncthreads();
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = q * 4;
  if (i >= n) return;
  if (vec && i + 4 <= n) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < n_w; ++r) {
      const char4 c = reinterpret_cast<const char4*>(codes + r * ld)[q];
      const float w = sw[r];
      acc.x = __fadd_rn(acc.x, __fmul_rn(w, static_cast<float>(c.x)));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w, static_cast<float>(c.y)));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w, static_cast<float>(c.z)));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w, static_cast<float>(c.w)));
    }
    reinterpret_cast<float4*>(out)[q] = acc;
  } else {
    for (long long k = i; k < n && k < i + 4; ++k) {
      float acc = 0.0f;
      for (int r = 0; r < n_w; ++r)
        acc = __fadd_rn(acc, __fmul_rn(sw[r], static_cast<float>(codes[r * ld + k])));
      out[k] = acc;
    }
  }
}

}  // namespace

extern "C" int int8_acc_launch(const signed char* codes, long long ld, const float* weights,
                               int n_w, float* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(codes) % 4 == 0) && (ld % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int threads = 256;
  const long long quads = (n + 3) / 4;
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  int8_acc_kernel<<<blocks, threads, n_w * sizeof(float), stream>>>(codes, ld, weights, n_w, out,
                                                                    n, vec);
  return static_cast<int>(cudaGetLastError());
}
