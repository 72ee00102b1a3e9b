// Threshold sparsification for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/threshold_sparsify.py::threshold_2d
// (_thresh_kernel):
//   keep = |x| >= tau;  out = keep ? x : +0.0;  counts[b] = sum of keep over block b
// with blocks of 32,768 elements (the reference's 256 x 128 tile), one int32
// count per block.  tau is read from device memory: the adaptive threshold
// computes it on the card, and a host copy would wait for the queue.  NaN is
// never kept (the comparison is false); a kept -0.0 stays -0.0.  The tail
// block is masked here, not padded, so it counts only real elements.
//
// Bound: bytes.  Per element it reads x (4 B) and writes the masked value
// (4 B), plus 4 B per block of counts, against two f32 operations.  Design:
// one CTA of 256 threads per block; each thread walks the block with float4
// loads and stores (neighbouring threads on neighbouring 16-byte words),
// 32 of them; the kept count is summed by warp shuffles and then across the
// 8 warps in shared memory.  A block that is partial or unaligned takes a
// scalar loop.  64-bit offsets throughout.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256 * 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float keep_one(float x, float tau, int& kept) {
  const bool keep = fabsf(x) >= tau;
  kept += keep;
  return keep ? x : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
threshold_kernel(const float* __restrict__ x, const float* __restrict__ tau_ptr,
                 float* __restrict__ out, int* __restrict__ counts, long long n, int vec) {
  const long long start = static_cast<long long>(blockIdx.x) * kBlock;
  const long long end = start + kBlock < n ? start + kBlock : n;
  const float tau = __ldg(tau_ptr);
  int kept = 0;
  if (vec && end - start == kBlock) {
    const float4* x4 = reinterpret_cast<const float4*>(x + start);
    float4* o4 = reinterpret_cast<float4*>(out + start);
#pragma unroll 4
    for (int j = threadIdx.x; j < kBlock / 4; j += kThreads) {
      const float4 v = x4[j];
      float4 r;
      r.x = keep_one(v.x, tau, kept);
      r.y = keep_one(v.y, tau, kept);
      r.z = keep_one(v.z, tau, kept);
      r.w = keep_one(v.w, tau, kept);
      o4[j] = r;
    }
  } else {
    for (long long k = start + threadIdx.x; k < end; k += kThreads)
      out[k] = keep_one(x[k], tau, kept);
  }
  for (int off = 16; off > 0; off >>= 1) kept += __shfl_down_sync(0xffffffffu, kept, off);
  __shared__ int warp_kept[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_kept[w];
    counts[blockIdx.x] = total;
  }
}

}  // namespace

extern "C" int threshold_launch(const float* x, const float* tau, float* out, int* counts,
                                long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const long long blocks = (n + kBlock - 1) / kBlock;
  threshold_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      x, tau, out, counts, n, vec);
  return static_cast<int>(cudaGetLastError());
}
