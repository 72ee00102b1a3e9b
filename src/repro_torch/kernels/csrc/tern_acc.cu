// Fused 2-bit unpack + weighted accumulate over gathered ternary rows, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wire_reduce.py::tern_acc_3d
// (_tern_acc_kernel):  out[e] = sum_w weights[w] * ([c_w(e) = 1] - [c_w(e) = 3])
// in f32, over W gathered packed rows in the lane-interleaved layout
// (element e is crumb (e / 128) % 4, bits 2k..2k+1, of byte
// (e / 512) * 128 + e % 128); crumb 2 decodes to 0.  The weights carry the
// per-worker epilogue (the ternary scale).  The (W, n) decode never exists
// in device memory, and only outputs e < n are written.
//
// Bound: bytes.  It reads W/4 B and writes 4 B per element: W/4 + 4
// B/element (5 at W = 4).  Design: one thread per 4 byte positions (lanes
// l..l+3 of one byte row) and 16 f32 accumulators in registers; for
// w = 0..W-1 in order it reads that 32-bit word of row w (row w starts at
// packed + w * ld) and adds value * weight per crumb, value in {-1, 0, +1}
// (the product is exact, and a non-finite weight poisons its sums as in the
// reference), one round-to-nearest add each, as the plain version does.  The
// (W,) weights sit in shared memory.  Each thread then writes float4s at
// out[r*512 + k*128 + l], 512 contiguous bytes per warp per slot.  A masked
// scalar path covers the ragged tail and unaligned pointers; offsets are
// 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float decode(unsigned int c) {
  return c == 1u ? 1.0f : (c == 3u ? -1.0f : 0.0f);
}

__global__ void tern_acc_kernel(const unsigned char* __restrict__ packed, long long ld,
                                const float* __restrict__ weights, int n_w,
                                float* __restrict__ out, long long n, int vec_in, int vec_out) {
  extern __shared__ float sw[];
  for (int k = threadIdx.x; k < n_w; k += blockDim.x) sw[k] = weights[k];
  __syncthreads();
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long b = q * 4;
  const long long base = (b >> 7) * 512 + (b & 127);  // element of slot 0, lane l
  if (base >= n) return;
  float acc[16];  // acc[k * 4 + j]: slot k of byte b + j
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  for (int w = 0; w < n_w; ++w) {
    const unsigned char* row = packed + w * ld + b;
    const unsigned int word =
        vec_in ? *reinterpret_cast<const unsigned int*>(row)
               : (static_cast<unsigned int>(row[0]) | (static_cast<unsigned int>(row[1]) << 8) |
                  (static_cast<unsigned int>(row[2]) << 16) |
                  (static_cast<unsigned int>(row[3]) << 24));
    const float wt = sw[w];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[k * 4 + j] = __fadd_rn(acc[k * 4 + j],
                                   __fmul_rn(decode((word >> (8 * j + 2 * k)) & 3u), wt));
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long e = base + k * 128;
    if (vec_out && e + 4 <= n) {
      *reinterpret_cast<float4*>(out + e) =
          make_float4(acc[k * 4], acc[k * 4 + 1], acc[k * 4 + 2], acc[k * 4 + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < n) out[e + j] = acc[k * 4 + j];
    }
  }
}

}  // namespace

// Each row must hold ceil(n / 512) * 128 bytes (the wrapper checks it).
extern "C" int tern_acc_launch(const unsigned char* packed, long long ld, const float* weights,
                               int n_w, float* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec_in = (reinterpret_cast<uintptr_t>(packed) % 4 == 0) && (ld % 4 == 0);
  const int vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int threads = 256;
  const long long quads = (n + 511) / 512 * 32;  // 4-byte groups of the byte rows in use
  const unsigned int blocks = static_cast<unsigned int>((quads + threads - 1) / threads);
  tern_acc_kernel<<<blocks, threads, n_w * sizeof(float), stream>>>(packed, ld, weights, n_w,
                                                                    out, n, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}
