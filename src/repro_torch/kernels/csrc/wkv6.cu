// WKV6 recurrence (the RWKV6 time mix) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6_chunked (_wkv_kernel).
// Per head (b, h), with the state S (hd x hd, f32) carried across time:
//   kv[i][j] = k_t[i] * v_t[j]
//   y_t[j]   = sum_i r_t[i] * (S[i][j] + u[i] * kv[i][j])
//   S[i][j]  = w_t[i] * S[i][j] + kv[i][j]
// r, k, v, w are read in place in the model's (B, S, H, hd) layout: head
// (b, h) at time t is hd contiguous elements at ((b*S + t)*H + h)*hd.  r, k
// and v are bf16 or f32 and are widened in registers, which is exact; w, u
// and s0 are f32; y (B, S, H, hd) and sT (B, H, hd, hd) are written as f32.
// No padding of S and no relayout copies: the TPU kernel's (BH, S/chunk)
// grid, VMEM scratch and padding of S to the chunk do not carry over.
//
// Rounding: every product and sum is its own __fmul_rn / __fadd_rn (and the
// build passes --fmad=false), so each step of S rounds as the plain
// version's `w * S + kv` does and sT agrees with it bit for bit.  y is a dot
// product over i summed in ascending i, another order than the plain
// version's einsum.
//
// Bound: operations.  The function needs about 5*hd^2 f32 operations per
// (b, h, t) (this kernel spends 7*hd^2: it forms u*kv for every (i, j))
// against (3*sizeof(r) + 4 + 4)*hd bytes of r, k, v, w and y.  The recurrence is
// serial in t; this design is the simple one: one CTA per (b, h), thread j
// owns column j of S in registers (the i loop is unrolled at compile time,
// so hd is a template parameter: 16, 32, 64 or 80), and chunks of kT time
// steps of r, k, v, w are staged into shared memory with cp.async, double
// buffered, so the loads of chunk c+1 overlap the steps of chunk c and
// there are two barriers per chunk, not per step.  Every thread reads
// r[i], k[i], w[i], u[i] as shared-memory broadcasts, four at a time.  The
// chain of hd dependent adds into y_t[j] and the threads of the last warp
// above hd (16 of 96 at hd 80) are what it leaves on the table; a chunked
// form on the tensor cores is later work.  Shared memory: 2 buffers x kT x
// hd x (3*sizeof(r) + 4) bytes + 4*hd, at most 41,280 bytes (hd 80, f32
// inputs), so it stays static (under 48 KB).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;  // time steps staged per chunk

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive elements of a shared tile, widened (16-byte or 8-byte
// aligned: i is a multiple of 4 and every row starts 16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(q.x << 16); o[1] = __uint_as_float(q.x & 0xffff0000u);
  o[2] = __uint_as_float(q.y << 16); o[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying n time steps of head (b, h), from row `row0` (= (b*S + t0)*H
// + h) on, of one (B, S, H, HD) array into a [kT][HD] tile.
template <typename T, int HD, int NT>
__device__ __forceinline__ void stage(T* tile, const T* g, long long row0, int H, int n) {
  constexpr int kUnits = HD * static_cast<int>(sizeof(T)) / 16;  // 16-byte units per row
  for (int q = threadIdx.x; q < n * kUnits; q += NT) {
    const int t = q / kUnits, c = q % kUnits;
    const long long row = row0 + static_cast<long long>(t) * H;
    const char* src = reinterpret_cast<const char*>(g + row * HD);
    cp_async16(reinterpret_cast<char*>(tile + t * HD) + c * 16, src + c * 16);
  }
}

template <int HD>
__host__ __device__ constexpr int threads_for() { return (HD + 31) / 32 * 32; }

template <typename TIn, int HD>
__global__ void __launch_bounds__(threads_for<HD>())
wkv6_kernel(const TIn* __restrict__ r, const TIn* __restrict__ k, const TIn* __restrict__ v,
            const float* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sT,
            int S, int H) {
  constexpr int NT = threads_for<HD>();
  static_assert(HD % 8 == 0, "rows must be whole 16-byte units");
  __shared__ __align__(16) TIn sr[2][kT][HD];
  __shared__ __align__(16) TIn sk[2][kT][HD];
  __shared__ __align__(16) TIn sv[2][kT][HD];
  __shared__ __align__(16) float sw[2][kT][HD];
  __shared__ __align__(16) float su[HD];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const bool active = j < HD;
  for (int i = j; i < HD; i += NT) su[i] = u[h * HD + i];

  const long long state0 = static_cast<long long>(bh) * HD * HD;
  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = active ? s0[state0 + i * HD + j] : 0.0f;

  const int chunks = (S + kT - 1) / kT;
  auto issue = [&](int c) {
    const int buf = c & 1, n = min(kT, S - c * kT);
    const long long row0 = (static_cast<long long>(b) * S + c * kT) * H + h;
    stage<TIn, HD, NT>(&sr[buf][0][0], r, row0, H, n);
    stage<TIn, HD, NT>(&sk[buf][0][0], k, row0, H, n);
    stage<TIn, HD, NT>(&sv[buf][0][0], v, row0, H, n);
    stage<float, HD, NT>(&sw[buf][0][0], w, row0, H, n);
    cp_async_commit();
  };
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, n = min(kT, S - c * kT);
    if (c + 1 < chunks) {
      issue(c + 1);  // into the other buffer, free since the barrier ending chunk c-1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and su) visible to every thread
    for (int t = 0; t < n; ++t) {
      const float vj = active ? widen(sv[buf][t][j]) : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int i0 = 0; i0 < HD; i0 += 4) {
        float ri[4], ki[4], wi[4], ui[4];
        load4(&sr[buf][t][i0], ri);
        load4(&sk[buf][t][i0], ki);
        load4(&sw[buf][t][i0], wi);
        load4(&su[i0], ui);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + q;
          const float kv = __fmul_rn(ki[q], vj);
          acc = __fadd_rn(acc, __fmul_rn(ri[q], __fadd_rn(s[i], __fmul_rn(ui[q], kv))));
          s[i] = __fadd_rn(__fmul_rn(wi[q], s[i]), kv);
        }
      }
      if (active)
        y[((static_cast<long long>(b) * S + c * kT + t) * H + h) * HD + j] = acc;
    }
    __syncthreads();  // every thread done with buffer `buf` before it is refilled
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < HD; ++i) sT[state0 + i * HD + j] = s[i];
  }
}

template <typename TIn, int HD>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, float* y, float* sT, int B, int S, int H, cudaStream_t stream) {
  wkv6_kernel<TIn, HD><<<B * H, threads_for<HD>(), 0, stream>>>(
      static_cast<const TIn*>(r), static_cast<const TIn*>(k), static_cast<const TIn*>(v), w,
      u, s0, y, sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_hd(int hd, const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, float* y, float* sT, int B, int S, int H,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<TIn, 16>(r, k, v, w, u, s0, y, sT, B, S, H, stream);
    case 32: return launch<TIn, 32>(r, k, v, w, u, s0, y, sT, B, S, H, stream);
    case 64: return launch<TIn, 64>(r, k, v, w, u, s0, y, sT, B, S, H, stream);
    case 80: return launch<TIn, 80>(r, k, v, w, u, s0, y, sT, B, S, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: (B, S, H, hd), bf16 if rkv_bf16 else f32; w: (B, S, H, hd) f32;
// u: (H, hd) f32; s0: (B, H, hd, hd) f32.  Writes y (B, S, H, hd) and sT
// (B, H, hd, hd), f32.  Every pointer 16-byte aligned, every array
// contiguous; hd in {16, 32, 64, 80}; S >= 1.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const float* w,
                           const float* u, const float* s0, float* y, float* sT, int B, int S,
                           int H, int hd, int rkv_bf16, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return rkv_bf16
             ? launch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, sT, B, S, H, stream)
             : launch_hd<float>(hd, r, k, v, w, u, s0, y, sT, B, S, H, stream);
}
