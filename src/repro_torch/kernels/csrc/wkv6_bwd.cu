// The gradient of the WKV6 recurrence (kernel wkv6) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains RWKV6 through `wkv_scan`
// (repro/models/rwkv.py, a lax.scan), whose gradient XLA derives; the port
// runs its forward through kernel wkv6, so it needs this backward for it.
// With P_t the state before step t (P_0 = s0), y_t = r_t^T (P_t + u k_t
// v_t^T) and P_{t+1} = w_t (.)rows P_t + k_t v_t^T, and D the gradient of the
// state after step t (D = dsT at t = S - 1):
//   dr_t = P_t dy_t + u k_t (v_t . dy_t)       dk_t = D v_t + r_t u (v_t . dy_t)
//   dv_t = D^T k_t + (sum_i r_t u k_t) dy_t    dw_t[i] = sum_j D[i,j] P_t[i,j]
//   du  += r_t k_t (v_t . dy_t)                D <- w_t (.)rows D + r_t dy_t^T
// and ds0 = D after step 0.  No step divides by w, so a decay that
// underflowed to 0 is safe (ref.wkv6_backward repeats this arithmetic).
//
// Design (a simple one that is right first).  One CTA per (b, h), two groups
// of 32*ceil(hd/32) threads: thread i of the row group owns row i of D in
// registers and computes dr, dk, dw and du's partial for channel i; thread j
// of the column group owns column j of a second copy of D and computes dv_j.
// Both copies take the same rounded operations (every product and sum is its
// own __fmul_rn / __fadd_rn, and the build passes --fmad=false), so they stay
// equal, and no step needs a reduction across threads or a barrier.  The
// states are rebuilt, never divided back: a forward sweep by the row group
// checkpoints P every kC = 8 steps into device memory (B*H*ceil(S/8) states);
// the reverse sweep takes the chunks last to first, stages the chunk's r, k,
// v, w, dy (widened to f32) in shared memory, rebuilds the chunk's 8 states
// there from its checkpoint (thread i its own row: no barrier), then walks
// the chunk's steps backwards.  du's partials are written per (b, h); the
// wrapper sums them with one torch.sum, so no float atomics: the gradient is
// bitwise from run to run.
// Shared memory per CTA (dynamic): 8 states (8 x hd x hd x 4 B, laid out
// [t][j][i] so a warp's threads read consecutive words) and the staged chunk
// (5 x 8 x hd x 4 B) and u: at hd 80, 204,800 + 12,800 + 320 = 217,920 bytes,
// one CTA per SM; the training shape (2, 1024, 32, 80) has 64 heads, one wave.
// Bound: at (2, 1024, 32, 80) with bf16 r, k, v the function moves ~162 MB
// (inputs read once, dr, dk, dv, dw written as f32) and needs 14 hd^2 flops a
// head and step (the states rebuilt 3, dr, dk, dv, dw 2 each, D's update 3),
// 5.9 GFLOP: bytes bound it on the card.  This design runs the time axis
// serially in each CTA on the CUDA cores, so it sits far above that bound;
// chip_smoke.py prints its time beside it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kC = 8;  // steps per checkpoint and per staged chunk

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int HD>
__host__ __device__ constexpr int group_threads() { return (HD + 31) / 32 * 32; }

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kC) * HD * HD + 5 * kC * HD + HD) * sizeof(float);
}

// Stage n steps from t0 on of one (B, S, H, HD) array of head (b, h) into a
// [kC][HD] f32 tile, widened; every thread of the CTA takes part.
template <int HD, int NT, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int b, int h, int S, int H,
                                      int t0, int n) {
  for (int q = threadIdx.x; q < n * HD; q += NT) {
    const int t = q / HD, c = q % HD;
    dst[t * HD + c] = widen(src[((static_cast<long long>(b) * S + t0 + t) * H + h) * HD + c]);
  }
}

template <typename TIn, int HD>
__global__ void __launch_bounds__(2 * group_threads<HD>())
wkv6_bwd_kernel(const TIn* __restrict__ r, const TIn* __restrict__ k, const TIn* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ s0, const float* __restrict__ dy,
                const float* __restrict__ dsT, float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                float* __restrict__ ds0, float* __restrict__ ckpt, int S, int H) {
  constexpr int NG = group_threads<HD>();
  extern __shared__ __align__(16) float smem[];
  float* sP = smem;                    // [kC][HD (j)][HD (i)]
  float* sr = sP + kC * HD * HD;       // [kC][HD]
  float* sk = sr + kC * HD;
  float* sv = sk + kC * HD;
  float* sw = sv + kC * HD;
  float* sdy = sw + kC * HD;
  float* su = sdy + kC * HD;           // [HD]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const bool row_group = tid < NG;
  const int i = row_group ? tid : tid - NG;  // the row (row group) or column (column group)
  const bool active = i < HD;
  const long long state0 = static_cast<long long>(bh) * HD * HD;
  const int chunks = (S + kC - 1) / kC;
  float* ck = ckpt + static_cast<long long>(bh) * chunks * HD * HD;  // [chunk][j][i]
  for (int q = tid; q < HD; q += 2 * NG) su[q] = u[h * HD + q];

  auto stage_all = [&](int t0, int n, bool all) {
    if (all) stage<HD, 2 * NG>(sr, r, b, h, S, H, t0, n);
    stage<HD, 2 * NG>(sk, k, b, h, S, H, t0, n);
    stage<HD, 2 * NG>(sv, v, b, h, S, H, t0, n);
    stage<HD, 2 * NG>(sw, w, b, h, S, H, t0, n);
    if (all) stage<HD, 2 * NG>(sdy, dy, b, h, S, H, t0, n);
  };

  // 1. forward sweep: the state at the start of every chunk
  {
    float p[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) p[j] = (row_group && active) ? s0[state0 + i * HD + j] : 0.0f;
    for (int c = 0; c < chunks; ++c) {
      if (row_group && active) {
#pragma unroll
        for (int j = 0; j < HD; ++j) ck[(static_cast<long long>(c) * HD + j) * HD + i] = p[j];
      }
      if (c + 1 == chunks) break;
      __syncthreads();  // the previous chunk's staged values are read
      stage_all(c * kC, kC, false);  // k, v, w
      __syncthreads();
      if (row_group && active) {
        for (int t = 0; t < kC; ++t) {
          const float wi = sw[t * HD + i], ki = sk[t * HD + i];
#pragma unroll
          for (int j = 0; j < HD; ++j)
            p[j] = __fadd_rn(__fmul_rn(wi, p[j]), __fmul_rn(ki, sv[t * HD + j]));
        }
      }
    }
  }

  // 2. reverse sweep
  float d[HD];  // row i of D (row group) or column j = i of D (column group)
#pragma unroll
  for (int x = 0; x < HD; ++x) {
    float val = 0.0f;
    if (active && dsT != nullptr)
      val = row_group ? dsT[state0 + i * HD + x] : dsT[state0 + x * HD + i];
    d[x] = val;
  }
  float du_acc = 0.0f;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * kC, n = min(kC, S - t0);
    __syncthreads();  // every thread is done with the chunk staged before
    stage_all(t0, n, true);
    __syncthreads();
    if (row_group && active) {
      // the chunk's states: thread i writes and later reads only its own row
      const float* src = ck + static_cast<long long>(c) * HD * HD;
      for (int j = 0; j < HD; ++j) sP[j * HD + i] = src[j * HD + i];
      for (int t = 1; t < n; ++t) {
        const float wi = sw[(t - 1) * HD + i], ki = sk[(t - 1) * HD + i];
        for (int j = 0; j < HD; ++j)
          sP[(t * HD + j) * HD + i] = __fadd_rn(__fmul_rn(wi, sP[((t - 1) * HD + j) * HD + i]),
                                                __fmul_rn(ki, sv[(t - 1) * HD + j]));
      }
    }
    for (int t = n - 1; t >= 0; --t) {
      const float* rt = sr + t * HD;
      const float* kt = sk + t * HD;
      const float* vt = sv + t * HD;
      const float* wt = sw + t * HD;
      const float* dyt = sdy + t * HD;
      const long long out = ((static_cast<long long>(b) * S + t0 + t) * H + h) * HD + i;
      if (row_group) {
        if (active) {
          const float* Pt = sP + t * HD * HD;
          const float ri = rt[i], ki = kt[i], wi = wt[i], ui = su[i];
          float vdy = 0.0f, acc_r = 0.0f, acc_k = 0.0f, acc_w = 0.0f;
#pragma unroll
          for (int j = 0; j < HD; ++j) {
            const float pj = Pt[j * HD + i], dyj = dyt[j], vj = vt[j];
            vdy = __fadd_rn(vdy, __fmul_rn(vj, dyj));
            acc_r = __fadd_rn(acc_r, __fmul_rn(pj, dyj));
            acc_k = __fadd_rn(acc_k, __fmul_rn(d[j], vj));
            acc_w = __fadd_rn(acc_w, __fmul_rn(d[j], pj));
            d[j] = __fadd_rn(__fmul_rn(wi, d[j]), __fmul_rn(ri, dyj));
          }
          dr[out] = __fadd_rn(acc_r, __fmul_rn(__fmul_rn(ui, ki), vdy));
          dk[out] = __fadd_rn(acc_k, __fmul_rn(__fmul_rn(ri, ui), vdy));
          dw[out] = acc_w;
          du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(ri, ki), vdy));
        }
      } else if (active) {
        const float dyj = dyt[i];
        float ruk = 0.0f, acc_v = 0.0f;
#pragma unroll
        for (int x = 0; x < HD; ++x) {
          const float rx = rt[x], kx = kt[x];
          ruk = __fadd_rn(ruk, __fmul_rn(__fmul_rn(rx, su[x]), kx));
          acc_v = __fadd_rn(acc_v, __fmul_rn(d[x], kx));
          d[x] = __fadd_rn(__fmul_rn(wt[x], d[x]), __fmul_rn(rx, dyj));
        }
        dv[out] = __fadd_rn(acc_v, __fmul_rn(ruk, dyj));
      }
    }
  }
  if (row_group && active) {
#pragma unroll
    for (int j = 0; j < HD; ++j) ds0[state0 + i * HD + j] = d[j];
    du_part[static_cast<long long>(bh) * HD + i] = du_acc;
  }
}

template <typename TIn, int HD>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, const float* dy, const float* dsT, float* dr, float* dk, float* dv,
           float* dw, float* du_part, float* ds0, float* ckpt, int B, int S, int H,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  static bool ready = false;  // the shared-memory opt-in, once per instantiation
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_kernel<TIn, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  wkv6_bwd_kernel<TIn, HD><<<B * H, 2 * group_threads<HD>(), bytes, stream>>>(
      static_cast<const TIn*>(r), static_cast<const TIn*>(k), static_cast<const TIn*>(v), w,
      u, s0, dy, dsT, dr, dk, dv, dw, du_part, ds0, ckpt, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_hd(int hd, const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, const float* dy, const float* dsT, float* dr,
              float* dk, float* dv, float* dw, float* du_part, float* ds0, float* ckpt, int B,
              int S, int H, cudaStream_t stream) {
  auto f = [&](auto c) {
    return launch<TIn, decltype(c)::value>(r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du_part,
                                           ds0, ckpt, B, S, H, stream);
  };
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: (B, S, H, hd), bf16 if rkv_bf16 else f32; w, dy: (B, S, H, hd)
// f32; u: (H, hd) f32; s0: (B, H, hd, hd) f32; dsT: the same or null (zero).
// Writes dr, dk, dv, dw (B, S, H, hd), du_part (B, H, hd) (to be summed over
// B) and ds0 (B, H, hd, hd), f32, using ckpt (B * H * ceil(S / ckpt_steps) *
// hd * hd floats) as scratch.  ckpt_steps must be the kernel's kC (8).  Every
// array contiguous; hd in {16, 32, 64, 80}; S >= 1.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* w,
                               const float* u, const float* s0, const float* dy,
                               const float* dsT, float* dr, float* dk, float* dv, float* dw,
                               float* du_part, float* ds0, float* ckpt, int B, int S, int H,
                               int hd, int rkv_bf16, int ckpt_steps, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || ckpt_steps != kC)
    return static_cast<int>(cudaErrorInvalidValue);
  return rkv_bf16 ? launch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw,
                                             du_part, ds0, ckpt, B, S, H, stream)
                  : launch_hd<float>(hd, r, k, v, w, u, s0, dy, dsT, dr, dk, dv, dw, du_part,
                                     ds0, ckpt, B, S, H, stream);
}
