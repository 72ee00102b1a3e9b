// The gradient of the WKV6 recurrence (kernel wkv6) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference trains RWKV6 through `wkv_scan`
// (repro/models/rwkv.py, a lax.scan), whose gradient XLA derives; the port
// runs its forward through kernel wkv6, so it needs this backward for it.
// With P_t the state before step t (P_0 = s0), y_t = r_t^T (P_t + u k_t
// v_t^T) and P_{t+1} = w_t (.)rows P_t + k_t v_t^T, and D_t the gradient of
// the state after step t (dsT after the last step):
//   dr_t = P_t dy_t + u k_t (v_t . dy_t)       dk_t = D_t v_t + r_t u (v_t . dy_t)
//   dv_t = D_t^T k_t + (sum_i r_t u k_t) dy_t  dw_t[i] = sum_j D_t[i,j] P_t[i,j]
//   du = sum_t r_t k_t (v_t . dy_t)            D_{t-1} = w_t (.)rows D_t + r_t dy_t^T
// and ds0 = D_{-1}.
//
// What bounds it.  At the training shape (2, 1024, 32, 80) with bf16 r, k, v
// the function moves ~162 MB (inputs read once; dr, dk, dv, dw written as
// f32) and needs 14 hd^2 flops a head and step, 5.9 GFLOP: 0.048 ms of bytes
// against 0.012 ms of TF32 tensor-core operations, so bytes.  The recurrence
// is serial in time only through the states; everything else is parallel.
// This design moves more than the function must (~410 MB: the boundary
// states out and back, the inputs read by both passes and a chunk's last
// three sub-chunks staged twice) and its CTAs are latency-bound (one per SM; barrier-separated
// phases of dependent mma.sync and FMA chains): `python -m
// repro_torch.kernels.probe bwd` times each phase compiled out.
//
// Design: two launches, parallel over time (ref.wkv6_bwd_states and
// ref.wkv6_backward_chunked repeat their arithmetic in plain PyTorch).
//
// 1. wkv6_bwd_states: the states at the boundaries of chunks of kC = 64
//    steps.  P goes forward over the chunks, P <- E (.)rows P + (k *
//    sigma)^T v, and D backward, D <- E (.)rows D + (r * rho)^T dy, where per
//    channel E is the product of the chunk's decays and sigma / rho the
//    running products of w after / before each step.  The decays are running
//    products of w itself (the one-sided factors of the forward's factored
//    form: every factor <= 1, so nothing overflows, no exp2 or log2 rounds
//    and no floor is needed, and w = 0 is exact); two threads a channel take
//    half a chunk each, one half scaled by the other's product.  One CTA of
//    hd/16 warps per (b, h) and kind (P or D) keeps the whole state in mma
//    accumulators (warp w rows 16w..16w+15, every column) across the chunks,
//    the next chunk staged by cp.async while one is used: 2 B H CTAs, 128 at
//    the training shape, one wave.  It writes P before each chunk and D
//    after each chunk (one state of each kind per 64 steps per head: 2 x
//    26.2 MB at the training shape) and ds0.
// 2. wkv6_bwd: one CTA of 12 warps per (b, h, chunk), 1,024 at the training
//    shape.  Inside the chunk the sub-chunks of kL = 16 steps are taken
//    backward first, carrying D to the end of every sub-chunk (kept in
//    shared memory), then forward, carrying P, and each sub-chunk is computed
//    from its boundary states P and D alone (M = dy v^T, PD = dy P^T, GV = v
//    D^T; pi(s, t) = prod_{s<tau<t} w_tau):
//      dr_t = rho_t PD_t + sum_{s<t} pi(s,t) k_s M[t,s] + u k_t M[t,t]
//      dk_t = sigma_t GV_t + sum_{s>t} pi(t,s) r_s M[s,t] + r_t u M[t,t]
//      dv   = (k * sigma) D + A^T dy  (A the forward's intra-chunk scores)
//      dw_t = rho_t sigma_t rowsum(P * D) + rho_t sum_{s>t} pi(t,s) r_s PD_s
//             + sigma_t sum_{s<t} pi(s,t) k_s GV_s
//             + sum_{s<t<s'} pi(s,t) pi(t,s') k_s r_s' M[s',s]
//    the last the expansion of sum_j D_t[i,j] P_t[i,j] over the boundary
//    states: no step divides by w.  The products M, PD, GV, dv and the two
//    carries run on the tensor cores as mma.sync m16n8k8 TF32 in 3xTF32 (hi
//    * hi + hi * lo + lo * hi, f32 accumulation, three independent chains; a
//    widened bf16 is exact in TF32 and takes two); the 16 x 16 triangles
//    (running products along t, one thread per channel in three groups of
//    whole warps: dr, dk, the last dw term) and the scores A (one warp per
//    pair of columns, as kernel wkv6) run on the CUDA cores with explicit
//    __fmaf_rn (the build passes --fmad=false to every file).  Two barriers
//    a sub-chunk: phase 1 (k * sigma, A, M, PD, GV, rowsum(P * D)), phase 2
//    (dv, the three groups, and P carried by the warps past the groups; dw
//    is summed at the next sub-chunk's start).  Each sub-chunk's r, k, v, w,
//    dy are staged with cp.async, double buffered, while the one before is
//    computed.  du's partials go out per (b, h, chunk) and the wrapper adds
//    them with one torch.sum: no float atomics, the gradient is bitwise from
//    run to run.
// Shared memory of wkv6_bwd (dynamic) at hd 80: the four sub-chunk D's and P
// (5 x 80 x 84 x 4 B = 134,400), two staged sub-chunks (2 x 26,880 for f32
// r, k, v; 2 x 19,200 for bf16), k * sigma, PD, GV, two dw partials (5 x 16 x
// 84 x 4 = 26,880), M and A (2,560), E, rowsum(P * D), u (960): 218,560 bytes
// (f32) or 203,200 (bf16), so one CTA (12 warps, at most 170 registers a
// thread) per SM, and 1,024 CTAs take 7.8 waves over 132 SMs.
// wkv6_bwd_states at hd 80: two staged chunks (2 x 53,248 B for bf16 r, k, v,
// 2 x 63,488 for f32), the scaled operand (22,528), E and the halves'
// products (960): 129,984 or 150,464 bytes, one CTA (5 warps) per SM.
// chip_smoke.py prints what ptxas and the occupancy calculator give.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kC = 64;        // steps per chunk (per boundary state in device memory)
constexpr int kL = 16;        // steps per sub-chunk
constexpr int kSub = kC / kL;
constexpr int kWarps = 12;    // warps per CTA of wkv6_bwd
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// x = hi + lo, both TF32 (the 3xTF32 split; hi rounded half away from zero,
// as cvt.rna.tf32.f32, with integer operations; lo the remainder cut to
// TF32).  A widened bf16 (kExact) is its own high part; lo is then unused.
template <bool kExact, typename T>
__device__ __forceinline__ void part(T v, uint32_t& hi, uint32_t& lo) {
  const float x = widen(v);
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
  }
}

// d += a * b, one m16n8k8 TF32 product with f32 accumulation.  Fragments
// (g = lane / 4, q = lane % 4): a = A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4];
// b = B[q][g], B[q+4][g]; d = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of 3xTF32 into d[0] (hi * hi), d[1] (hi * lo) and d[2] (lo *
// hi): three independent chains, so no product waits on another of its
// k-step (mma.sync's dependent latency is ~24 cycles); an exact operand has
// no correction.  The tile's value is sum3.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[3][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d[0], ah, bh);
  if (!kExactB) mma(d[1], ah, bl);
  if (!kExactA) mma(d[2], al, bh);
}
__device__ __forceinline__ float sum3(const float (&d)[3][4], int e) {
  return __fadd_rn(d[0][e], __fadd_rn(d[1][e], d[2][e]));
}

// Fragment readers over a row-major [rows][PITCH] shared tile t, split.
// A[m][k] = t[m][k] (rows) or t[k][m] (cols); B[k][n] = t[k][n] (kn) or
// t[n][k] (nk).
template <int PITCH, bool kExact, typename T>
__device__ __forceinline__ void a_rows(const T* t, int m0, int k0, int g, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  part<kExact>(t[(m0 + g) * PITCH + k0 + q], hi[0], lo[0]);
  part<kExact>(t[(m0 + g + 8) * PITCH + k0 + q], hi[1], lo[1]);
  part<kExact>(t[(m0 + g) * PITCH + k0 + q + 4], hi[2], lo[2]);
  part<kExact>(t[(m0 + g + 8) * PITCH + k0 + q + 4], hi[3], lo[3]);
}
template <int PITCH, bool kExact, typename T>
__device__ __forceinline__ void a_cols(const T* t, int m0, int k0, int g, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  part<kExact>(t[(k0 + q) * PITCH + m0 + g], hi[0], lo[0]);
  part<kExact>(t[(k0 + q) * PITCH + m0 + g + 8], hi[1], lo[1]);
  part<kExact>(t[(k0 + q + 4) * PITCH + m0 + g], hi[2], lo[2]);
  part<kExact>(t[(k0 + q + 4) * PITCH + m0 + g + 8], hi[3], lo[3]);
}
template <int PITCH, bool kExact, typename T>
__device__ __forceinline__ void b_kn(const T* t, int k0, int n0, int g, int q,
                                     uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  part<kExact>(t[(k0 + q) * PITCH + n0 + g], hi[0], lo[0]);
  part<kExact>(t[(k0 + q + 4) * PITCH + n0 + g], hi[1], lo[1]);
}
template <int PITCH, bool kExact, typename T>
__device__ __forceinline__ void b_nk(const T* t, int k0, int n0, int g, int q,
                                     uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  part<kExact>(t[(n0 + g) * PITCH + k0 + q], hi[0], lo[0]);
  part<kExact>(t[(n0 + g) * PITCH + k0 + q + 4], hi[1], lo[1]);
}

// ---------------------------------------------------------------------------
// Launch 1, wkv6_bwd_states.
// ---------------------------------------------------------------------------

template <typename TIn, int HD>
struct States {
  static constexpr int NT = 2 * HD;   // threads: a warp per m-tile of 16 rows, 2 per row
  static constexpr int NB = HD / 8;   // n-tiles per warp: every column
  static constexpr int PX = HD + 8;   // pitch of the scaled operand (read as A^T)
  static constexpr int PB = HD + 8;   // pitch of the staged v or dy (read as B)
  // dynamic shared memory, in this order, two chunks staged (the next in
  // flight while one is used): x (k or r) [2][kC][HD] TIn, w [2][kC][HD] f32,
  // v or dy [2][kC][PB] (room for f32); then the scaled operand [kC][PX]
  // f32, E [HD], the halves' products of w [2][HD]
  static constexpr size_t x_bytes = static_cast<size_t>(kC) * HD * sizeof(TIn);
  static constexpr size_t w_bytes = static_cast<size_t>(kC) * HD * sizeof(float);
  static constexpr size_t b_bytes = static_cast<size_t>(kC) * PB * sizeof(float);
  static constexpr size_t buf_bytes = x_bytes + w_bytes + b_bytes;
  static constexpr size_t bytes =
      2 * buf_bytes + (static_cast<size_t>(kC) * PX + 3 * HD) * sizeof(float);
};

template <typename TIn, int HD>
__global__ void __launch_bounds__(States<TIn, HD>::NT)
wkv6_bwd_states_kernel(const TIn* __restrict__ r, const TIn* __restrict__ k,
                       const TIn* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ s0, const float* __restrict__ dy,
                       const float* __restrict__ dsT, float* __restrict__ Pscr,
                       float* __restrict__ Gscr, float* __restrict__ ds0, int S, int H) {
  using ST = States<TIn, HD>;
  constexpr int PX = ST::PX, PB = ST::PB, NB = ST::NB, NT = ST::NT;
  constexpr bool kVExact = sizeof(TIn) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sX = reinterpret_cast<float*>(smem + 2 * ST::buf_bytes);
  float* sE = sX + kC * PX;  // the chunk's product of w
  float* sHalf = sE + HD;    // [2][HD] each half-chunk's product of w

  const int fwd = blockIdx.x % 2 == 0, bh = blockIdx.x / 2, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int m0 = warp * 16, C = (S + kC - 1) / kC;
  const int steps = fwd ? C - 1 : C;  // chunks carried through
  const long long state0 = static_cast<long long>(bh) * HD * HD;
  const TIn* x = fwd ? k : r;
  auto buf = [&](int e, TIn*& xr, float*& wr, unsigned char*& br) {
    unsigned char* base = smem + (e & 1) * ST::buf_bytes;
    xr = reinterpret_cast<TIn*>(base);
    wr = reinterpret_cast<float*>(base + ST::x_bytes);
    br = base + ST::x_bytes + ST::w_bytes;
  };
  // start copying step e's chunk (forward: chunk e; backward: chunk C-1-e);
  // past the end of S: x = 0, w = 1, v or dy 0, which leave the state as it is
  auto issue = [&](int e) {
    TIn* xr;
    float* wr;
    unsigned char* br;
    buf(e, xr, wr, br);
    const int c = fwd ? e : C - 1 - e, n = min(kC, S - c * kC);
    const long long row0 = (static_cast<long long>(b) * S + c * kC) * H + h;
    constexpr int UX = HD * static_cast<int>(sizeof(TIn)) / 16, UW = HD / 4;
    const int per_row = UX + UW + (fwd ? UX : UW);
    for (int y = tid; y < n * per_row; y += NT) {
      const int t = y / per_row, z = y % per_row;
      const long long row = row0 + static_cast<long long>(t) * H;
      if (z < UX) {
        cp_async16(reinterpret_cast<char*>(xr + t * HD) + z * 16,
                   reinterpret_cast<const char*>(x + row * HD) + z * 16);
      } else if (z < UX + UW) {
        cp_async16(wr + t * HD + (z - UX) * 4, w + row * HD + (z - UX) * 4);
      } else if (fwd) {
        cp_async16(reinterpret_cast<TIn*>(br) + t * PB + (z - UX - UW) * (16 / sizeof(TIn)),
                   v + row * HD + (z - UX - UW) * (16 / sizeof(TIn)));
      } else {
        cp_async16(reinterpret_cast<float*>(br) + t * PB + (z - UX - UW) * 4,
                   dy + row * HD + (z - UX - UW) * 4);
      }
    }
    for (int y = tid; y < (kC - n) * HD; y += NT) {
      const int t = n + y / HD, i = y % HD;
      xr[t * HD + i] = TIn(0.0f);
      wr[t * HD + i] = 1.0f;
      if (fwd) reinterpret_cast<TIn*>(br)[t * PB + i] = TIn(0.0f);
      else reinterpret_cast<float*>(br)[t * PB + i] = 0.0f;
    }
    cp_async_commit();
  };

  // this lane's elements of the warp's NB 16 x 8 tiles: rows m0+g (+8),
  // columns nt*8 + 2q (+1)
  auto at = [&](int nt, int e) {
    return (m0 + g + (e >= 2 ? 8 : 0)) * HD + nt * 8 + 2 * q + (e & 1);
  };
  float acc[NB][4];
#pragma unroll
  for (int nt = 0; nt < NB; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nt][e] = fwd ? s0[state0 + at(nt, e)]
                       : (dsT != nullptr ? dsT[state0 + at(nt, e)] : 0.0f);
  auto store = [&](float* dst) {
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
      *reinterpret_cast<float2*>(dst + at(nt, 0)) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(dst + at(nt, 2)) = make_float2(acc[nt][2], acc[nt][3]);
    }
  };

  if (steps > 0) issue(0);
  for (int e = 0; e < steps; ++e) {
    const int c = fwd ? e : C - 1 - e;
    store((fwd ? Pscr : Gscr) + (static_cast<long long>(bh) * C + c) * HD * HD);
    cp_async_wait_all();
    __syncthreads();  // chunk e landed and is visible; chunk e-1's tiles are read
    if (e + 1 < steps) issue(e + 1);  // into the buffer chunk e-1 used
    TIn* xr;
    float* wr;
    unsigned char* br;
    buf(e, xr, wr, br);
    // the running products along the chunk, two threads per channel, each
    // over half of the chunk: sigma (forward) runs backward from the chunk's
    // end, so the first half's are scaled by the second half's product; rho
    // (backward) runs forward, so the second half's by the first's
    constexpr int kH = kC / 2;
    const int ch = tid % HD, hf = tid / HD, t0 = hf * kH;
    float xv[kH], loc[kH];
    {
      float wv[kH];
#pragma unroll
      for (int j = 0; j < kH; ++j) {  // the running products
        xv[j] = widen(xr[(t0 + j) * HD + ch]);
        wv[j] = wr[(t0 + j) * HD + ch];
      }
      float p = 1.0f;
      if (fwd) {
#pragma unroll
        for (int j = kH - 1; j >= 0; --j) {
          loc[j] = p;
          p = __fmul_rn(p, wv[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kH; ++j) {
          loc[j] = p;
          p = __fmul_rn(p, wv[j]);
        }
      }
      sHalf[hf * HD + ch] = p;
    }
    __syncthreads();
    {
      const float f = (fwd ? hf == 0 : hf == 1) ? sHalf[(1 - hf) * HD + ch] : 1.0f;
#pragma unroll
      for (int j = 0; j < kH; ++j) sX[(t0 + j) * PX + ch] = __fmul_rn(xv[j], __fmul_rn(loc[j], f));
      if (hf == 0) sE[ch] = __fmul_rn(sHalf[ch], sHalf[HD + ch]);
    }
    __syncthreads();
    const float ea = sE[m0 + g], eb = sE[m0 + g + 8];
    float d[NB][3][4];  // [n-tile][the three products of 3xTF32]
#pragma unroll
    for (int nt = 0; nt < NB; ++nt) {
      d[nt][0][0] = __fmul_rn(acc[nt][0], ea);
      d[nt][0][1] = __fmul_rn(acc[nt][1], ea);
      d[nt][0][2] = __fmul_rn(acc[nt][2], eb);
      d[nt][0][3] = __fmul_rn(acc[nt][3], eb);
#pragma unroll
      for (int y = 0; y < 4; ++y) d[nt][1][y] = d[nt][2][y] = 0.0f;
    }
    // the carry's products, one loop for each kind of B (v or dy), so that
    // no branch sits between the n-tiles' independent chains
    auto carry = [&](auto bsrc, auto exact) {
      constexpr bool kE = decltype(exact)::value;
#pragma unroll 2
      for (int ks = 0; ks < kC / 8; ++ks) {  // the carry's products
        uint32_t ah[4], al[4];
        a_cols<PX, false>(sX, m0, ks * 8, g, q, ah, al);
#pragma unroll
        for (int nt = 0; nt < NB; ++nt) {
          uint32_t bh2[2], bl2[2];
          b_kn<PB, kE>(bsrc, ks * 8, nt * 8, g, q, bh2, bl2);
          mma3<false, kE>(d[nt], ah, al, bh2, bl2);
        }
      }
    };
    if (fwd) carry(reinterpret_cast<const TIn*>(br), std::integral_constant<bool, kVExact>{});
    else carry(reinterpret_cast<const float*>(br), std::integral_constant<bool, false>{});
#pragma unroll
    for (int nt = 0; nt < NB; ++nt)
#pragma unroll
      for (int y = 0; y < 4; ++y) acc[nt][y] = sum3(d[nt], y);
  }
  if (fwd) store(Pscr + (static_cast<long long>(bh) * C + C - 1) * HD * HD);
  else store(ds0 + state0);
}

// ---------------------------------------------------------------------------
// Launch 2, wkv6_bwd: one CTA of kThreads per (b, h, chunk).
// ---------------------------------------------------------------------------

template <typename TIn, int HD>
struct Chunk {
  static constexpr int F = HD + 4;                                 // f32 tiles
  static constexpr int PT = HD + 16 / static_cast<int>(sizeof(TIn));  // staged r, k, v
  static constexpr int PS = HD + 4;                                // states
  static constexpr int AP = kL + 4;                                // M and A
  static constexpr int NT = HD / 8;   // n-tiles of 8 channels
  static constexpr int MT = HD / 16;  // m-tiles of 16 rows of a state
  static constexpr int KS = HD / 8;   // k-steps of 8 over the channels
  static constexpr size_t rkv_bytes = static_cast<size_t>(kL) * PT * sizeof(TIn);
  static constexpr size_t f_bytes = static_cast<size_t>(kL) * F * sizeof(float);
  static constexpr size_t stage_bytes = 3 * rkv_bytes + 2 * f_bytes;  // r, k, v, w, dy
  static constexpr size_t bytes =
      2 * stage_bytes +
      (static_cast<size_t>(kSub + 1) * HD * PS + 5 * kL * F + 2 * kL * AP + 3 * HD) * sizeof(float);
  static_assert(HD % 16 == 0, "hd must be a whole number of 16-row m-tiles");
  static_assert(rkv_bytes % 16 == 0 && f_bytes % 16 == 0, "16-byte aligned tiles");
  static constexpr int GS = (HD + 31) / 32 * 32;  // threads of a per-channel group, whole warps
  static_assert(3 * GS < kThreads, "three groups of one thread per channel, and warps to spare");
  static_assert(kWarps >= kL / 2 + 2, "one warp per pair of score columns, two for M");
  static_assert(kWarps % 2 == 0, "half the warps for PD, half for GV");
};

// One step of the butterfly that sums 32 values over the 32 lanes of a warp
// (lane l ends with the sum of value l).
template <int O>
__device__ __forceinline__ void reduce_step(float (&acc)[2 * kL], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float keep = upper ? acc[j + O] : acc[j];
    const float send = upper ? acc[j] : acc[j + O];
    acc[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
  }
}

template <typename TIn, int HD>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_kernel(const TIn* __restrict__ r, const TIn* __restrict__ k, const TIn* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ dy, const float* __restrict__ Pscr,
                const float* __restrict__ Gscr, float* __restrict__ dr, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ dw, float* __restrict__ du_part,
                int S, int H) {
  using CB = Chunk<TIn, HD>;
  constexpr int F = CB::F, PT = CB::PT, PS = CB::PS, AP = CB::AP, NT = CB::NT, MT = CB::MT,
                KS = CB::KS, GS = CB::GS;
  constexpr bool kX = sizeof(TIn) == 2;  // a widened bf16 r, k, v is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  float* sG = reinterpret_cast<float*>(smem + 2 * CB::stage_bytes);  // [kSub][HD][PS]
  float* sP = sG + kSub * HD * PS;  // [HD][PS] the live P
  float* sKh = sP + HD * PS;        // [kL][F] k * sigma (forward sweep), r * rho (backward)
  float* sPD = sKh + kL * F;        // [kL][F] dy P^T
  float* sGV = sPD + kL * F;        // [kL][F] v D^T
  float* sDW = sGV + kL * F;        // [2][kL][F] dw's partials
  float* sM = sDW + 2 * kL * F;     // [kL][AP] dy v^T
  float* sA = sM + kL * AP;         // [kL][AP] the scores A[t][s]
  float* sE = sA + kL * AP;         // [HD] the sub-chunk's product of w
  float* sRD = sE + HD;             // [HD] rowsum(P * D)
  float* sU = sRD + HD;             // [HD] u

  const int C = (S + kC - 1) / kC;
  const int bh = blockIdx.x / C, c = blockIdx.x % C, b = bh / H, h = bh % H;
  const int n = min(kC, S - c * kC), nsub = (n + kL - 1) / kL;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const long long sc = (static_cast<long long>(bh) * C + c) * HD * HD;
  const int stages = 2 * nsub - 1;  // sub-chunks nsub-1 .. 1 (D carried), then 0 .. nsub-1
  auto sub_of = [&](int e) { return e < nsub - 1 ? nsub - 1 - e : e - (nsub - 1); };
  auto tiles = [&](int e, TIn*& tr, TIn*& tk, TIn*& tv, float*& tw, float*& tdy) {
    unsigned char* base = smem + (e & 1) * CB::stage_bytes;
    tr = reinterpret_cast<TIn*>(base);
    tk = reinterpret_cast<TIn*>(base + CB::rkv_bytes);
    tv = reinterpret_cast<TIn*>(base + 2 * CB::rkv_bytes);
    tw = reinterpret_cast<float*>(base + 3 * CB::rkv_bytes);
    tdy = reinterpret_cast<float*>(base + 3 * CB::rkv_bytes + CB::f_bytes);
  };
  // start copying stage e's sub-chunk; pad rows (past the end of S) are set
  // here: r = k = v = dy = 0, w = 1, which changes no state and no output
  auto issue = [&](int e) {
    TIn *tr, *tk, *tv;
    float *tw, *tdy;
    tiles(e, tr, tk, tv, tw, tdy);
    const int t0 = sub_of(e) * kL, nq = min(kL, n - t0);
    const long long row0 = (static_cast<long long>(b) * S + c * kC + t0) * H + h;
    constexpr int UT = HD * static_cast<int>(sizeof(TIn)) / 16, UF = HD / 4;  // 16-B units a row
    for (int x = tid; x < nq * (3 * UT + 2 * UF); x += kThreads) {
      const int t = x / (3 * UT + 2 * UF), y = x % (3 * UT + 2 * UF);
      const long long row = row0 + static_cast<long long>(t) * H;
      if (y < 3 * UT) {
        const int a = y / UT, cu = y % UT;
        const TIn* src = (a == 0 ? r : a == 1 ? k : v) + row * HD;
        TIn* dst = (a == 0 ? tr : a == 1 ? tk : tv) + t * PT;
        cp_async16(reinterpret_cast<char*>(dst) + cu * 16,
                   reinterpret_cast<const char*>(src) + cu * 16);
      } else {
        const int a = (y - 3 * UT) / UF, cu = (y - 3 * UT) % UF;
        const float* src = (a == 0 ? w : dy) + row * HD;
        float* dst = (a == 0 ? tw : tdy) + t * F;
        cp_async16(dst + cu * 4, src + cu * 4);
      }
    }
    for (int x = tid; x < (kL - nq) * HD; x += kThreads) {
      const int t = nq + x / HD, i = x % HD;
      tr[t * PT + i] = tk[t * PT + i] = tv[t * PT + i] = TIn(0.0f);
      tw[t * F + i] = 1.0f;
      tdy[t * F + i] = 0.0f;
    }
    cp_async_commit();
  };

  // the chunk's boundary states: P before it, D after it (to slot nsub-1)
  for (int x = tid; x < HD * HD / 4; x += kThreads) {
    const int i = x / (HD / 4), cu = x % (HD / 4);
    cp_async16(sP + i * PS + cu * 4, Pscr + sc + i * HD + cu * 4);
    cp_async16(sG + ((nsub - 1) * HD + i) * PS + cu * 4, Gscr + sc + i * HD + cu * 4);
  }
  for (int i = tid; i < HD; i += kThreads) sU[i] = u[h * HD + i];
  issue(0);

  // the per-channel groups of whole warps: dr, dk, dw's last term; the
  // warps past them carry P while the groups work
  const int grp = tid / GS, ch = tid % GS;
  const bool chan = grp < 3 && ch < HD;
  float du_acc = 0.0f;
  float xw[kL];  // group 0's dw terms, written out once the other groups' are in
  long long dw_out0 = -1;  // the sub-chunk whose dw is pending (its first row), and its steps
  int dw_n = 0;
  auto write_dw = [&]() {
    if (!chan || grp != 0 || dw_out0 < 0) return;
#pragma unroll
    for (int t = 0; t < kL; ++t)
      if (t < dw_n)
        dw[(dw_out0 + static_cast<long long>(t) * H) * HD + ch] =
            __fadd_rn(__fadd_rn(xw[t], sDW[t * F + ch]), sDW[kL * F + t * F + ch]);
  };
  for (int e = 0; e < stages; ++e) {
    cp_async_wait_all();
    __syncthreads();  // stage e landed and is visible; every warp is done with stage e-1
    if (e + 1 < stages) issue(e + 1);  // into the buffer stage e-1 used
    TIn *cr, *ck, *cv;
    float *cw, *cdy;
    tiles(e, cr, ck, cv, cw, cdy);
    const int qs = sub_of(e);
    const float* G = sG + qs * HD * PS;  // D after this sub-chunk

    if (e < nsub - 1) {
      // ---- backward sweep: D before this sub-chunk = E * D + (r * rho)^T dy, into slot qs-1
      if (tid < HD) {
        float p = 1.0f;
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          sKh[t * F + tid] = __fmul_rn(widen(cr[t * PT + tid]), p);
          p = __fmul_rn(p, cw[t * F + tid]);
        }
        sE[tid] = p;
      }
      __syncthreads();
      float* Gn = sG + (qs - 1) * HD * PS;
#pragma unroll 1
      for (int unit = warp; unit < MT * NT / 2; unit += kWarps) {  // the D carry
        const int mt = unit / (NT / 2), j0 = unit % (NT / 2) * 2, i0 = mt * 16 + g;
        const float ea = sE[i0], eb = sE[i0 + 8];
        float d[2][3][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = (j0 + jj) * 8 + 2 * q;
          d[jj][0][0] = __fmul_rn(G[i0 * PS + col], ea);
          d[jj][0][1] = __fmul_rn(G[i0 * PS + col + 1], ea);
          d[jj][0][2] = __fmul_rn(G[(i0 + 8) * PS + col], eb);
          d[jj][0][3] = __fmul_rn(G[(i0 + 8) * PS + col + 1], eb);
#pragma unroll
          for (int x = 0; x < 4; ++x) d[jj][1][x] = d[jj][2][x] = 0.0f;
        }
#pragma unroll
        for (int ks = 0; ks < kL / 8; ++ks) {
          uint32_t ah[4], al[4];
          a_cols<F, false>(sKh, mt * 16, ks * 8, g, q, ah, al);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t bh2[2], bl2[2];
            b_kn<F, false>(cdy, ks * 8, (j0 + jj) * 8, g, q, bh2, bl2);
            mma3<false, false>(d[jj], ah, al, bh2, bl2);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = (j0 + jj) * 8 + 2 * q;
          Gn[i0 * PS + col] = sum3(d[jj], 0);
          Gn[i0 * PS + col + 1] = sum3(d[jj], 1);
          Gn[(i0 + 8) * PS + col] = sum3(d[jj], 2);
          Gn[(i0 + 8) * PS + col + 1] = sum3(d[jj], 3);
        }
      }
      continue;
    }

    // ---- forward sweep: sub-chunk qs from its P (sP) and D (G)
    const int t0 = qs * kL, nq = min(kL, n - t0);
    const long long out0 = (static_cast<long long>(b) * S + c * kC + t0) * H + h;
    write_dw();  // the sub-chunk before (its partials are in; phase 2 rewrites them)

    // Phase 1: k * sigma and E; the scores A; M, PD, GV; rowsum(P * D)
    if (tid >= kThreads - HD) {  // k * sigma, E, on the last warps (no score columns)
      const int i = tid - (kThreads - HD);
      float p = 1.0f;
#pragma unroll
      for (int t = kL - 1; t >= 0; --t) {
        sKh[t * F + i] = __fmul_rn(widen(ck[t * PT + i]), p);
        p = __fmul_rn(p, cw[t * F + i]);
      }
      sE[i] = p;
    }
    if (warp < kL / 2) {
      // A[t][s] = sum_i r_t k_s pi(s, t) below the diagonal, sum_i r_s u k_s
      // on it: this warp's columns sl and sl + 8, lanes over the channels
      const int sl = warp;
      float acc[2 * kL];
#pragma unroll
      for (int z = 0; z < 2 * kL; ++z) acc[z] = 0.0f;
      for (int i = lane; i < HD; i += 32) {  // the scores
        float rv[kL], wv[kL];
#pragma unroll
        for (int tt = 0; tt < kL; ++tt) {
          rv[tt] = widen(cr[tt * PT + i]);
          wv[tt] = cw[tt * F + i];
        }
        const float us = sU[i];
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          const int sz = sl + z * (kL / 2);
          float kf = widen(ck[sz * PT + i]);  // k_s prod_{s < tau < t} w_tau
#pragma unroll
          for (int tt = z * (kL / 2); tt < kL; ++tt) {  // selects, not branches: one chain
            const float f = tt == sz ? __fmul_rn(kf, us) : tt > sz ? kf : 0.0f;
            acc[z * kL + tt] = __fmaf_rn(rv[tt], f, acc[z * kL + tt]);
            kf = tt > sz ? __fmul_rn(kf, wv[tt]) : kf;
          }
        }
      }
      reduce_step<16>(acc, lane);
      reduce_step<8>(acc, lane);
      reduce_step<4>(acc, lane);
      reduce_step<2>(acc, lane);
      reduce_step<1>(acc, lane);
      sA[(lane % kL) * AP + sl + lane / kL * (kL / 2)] = acc[0];
    }
    // PD (NT tiles of 8 channels, dy against P) on warps [0, kWarps / 2), GV
    // (NT tiles, v against D) on the others, K = hd: a warp's tiles are of one
    // kind and share their A fragments, so their chains interleave; then M
    // (2 tiles of 8 s, dy against v) on the last two warps, which take no
    // score columns.
    {
      constexpr int HW = kWarps / 2, JW = (NT + HW - 1) / HW;
      const bool pd = warp < HW;
      const int w0 = pd ? warp : warp - HW;
      float d[JW][3][4] = {};
      __syncwarp();  // mma.sync wants the warp converged
      if (pd) {
#pragma unroll 2
        for (int ks = 0; ks < KS; ++ks) {  // M, PD, GV
          uint32_t ah[4], al[4];
          a_rows<F, false>(cdy, 0, ks * 8, g, q, ah, al);
#pragma unroll
          for (int x = 0; x < JW; ++x) {  // a tile past NT repeats the last, unstored
            uint32_t bh2[2], bl2[2];
            b_nk<PS, false>(sP, ks * 8, min(w0 + x * HW, NT - 1) * 8, g, q, bh2, bl2);
            mma3<false, false>(d[x], ah, al, bh2, bl2);
          }
        }
      } else {
#pragma unroll 2
        for (int ks = 0; ks < KS; ++ks) {  // M, PD, GV
          uint32_t ah[4], al[4];
          a_rows<PT, kX>(cv, 0, ks * 8, g, q, ah, al);
#pragma unroll
          for (int x = 0; x < JW; ++x) {
            uint32_t bh2[2], bl2[2];
            b_nk<PS, false>(G, ks * 8, min(w0 + x * HW, NT - 1) * 8, g, q, bh2, bl2);
            mma3<kX, false>(d[x], ah, al, bh2, bl2);
          }
        }
      }
      float* out = pd ? sPD : sGV;
#pragma unroll
      for (int x = 0; x < JW; ++x) {
        const int n0 = (w0 + x * HW) * 8;
        if (n0 >= HD) continue;
        out[g * F + n0 + 2 * q] = sum3(d[x], 0);
        out[g * F + n0 + 2 * q + 1] = sum3(d[x], 1);
        out[(g + 8) * F + n0 + 2 * q] = sum3(d[x], 2);
        out[(g + 8) * F + n0 + 2 * q + 1] = sum3(d[x], 3);
      }
      if (warp >= kWarps - 2) {
        const int n0 = (warp - (kWarps - 2)) * 8;
        float m[3][4] = {};
#pragma unroll 2
        for (int ks = 0; ks < KS; ++ks) {  // M, PD, GV
          uint32_t ah[4], al[4], bh2[2], bl2[2];
          a_rows<F, false>(cdy, 0, ks * 8, g, q, ah, al);
          b_nk<PT, kX>(cv, ks * 8, n0, g, q, bh2, bl2);
          mma3<false, kX>(m, ah, al, bh2, bl2);
        }
        sM[g * AP + n0 + 2 * q] = sum3(m, 0);
        sM[g * AP + n0 + 2 * q + 1] = sum3(m, 1);
        sM[(g + 8) * AP + n0 + 2 * q] = sum3(m, 2);
        sM[(g + 8) * AP + n0 + 2 * q + 1] = sum3(m, 3);
      }
    }
    if (warp < HD) {  // rowsum(P * D): rows warp, warp + kWarps, ... summed side by side
      constexpr int RW = (HD + kWarps - 1) / kWarps;
      float rs[RW];
#pragma unroll
      for (int m = 0; m < RW; ++m) {
        const int i = warp + m * kWarps;
        rs[m] = 0.0f;
        if (i < HD) {
#pragma unroll
          for (int j = lane; j < HD; j += 32)
            rs[m] = __fmaf_rn(sP[i * PS + j], G[i * PS + j], rs[m]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2)
#pragma unroll
        for (int m = 0; m < RW; ++m)
          rs[m] = __fadd_rn(rs[m], __shfl_xor_sync(0xffffffffu, rs[m], o));
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < RW; ++m)
          if (warp + m * kWarps < HD) sRD[warp + m * kWarps] = rs[m];
      }
    }
    __syncthreads();

    // Phase 2: dv = (k * sigma) D + A^T dy on the tensor cores; dr, dk and
    // dw's terms on the CUDA cores, one thread per channel in each group
#pragma unroll 1
    for (int job = warp; job < NT; job += kWarps) {  // dv
      const int n0 = job * 8;
      float d[2][3][4] = {};  // [k-step parity][3xTF32's three products]: six chains
#pragma unroll 1
      for (int ks = 0; ks < KS; ks += 2) {  // KS is even
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          uint32_t ah[4], al[4], bh2[2], bl2[2];
          a_rows<F, false>(sKh, 0, (ks + z) * 8, g, q, ah, al);
          b_kn<PS, false>(G, (ks + z) * 8, n0, g, q, bh2, bl2);
          mma3<false, false>(d[z], ah, al, bh2, bl2);
        }
      }
#pragma unroll
      for (int z = 0; z < kL / 8; ++z) {
        uint32_t ah[4], al[4], bh2[2], bl2[2];
        a_cols<AP, false>(sA, 0, z * 8, g, q, ah, al);
        b_kn<F, false>(cdy, z * 8, n0, g, q, bh2, bl2);
        mma3<false, false>(d[z], ah, al, bh2, bl2);
      }
      float o[4];
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) o[e2] = __fadd_rn(sum3(d[0], e2), sum3(d[1], e2));
      const int col = n0 + 2 * q;
      if (g < nq)
        *reinterpret_cast<float2*>(dv + (out0 + static_cast<long long>(g) * H) * HD + col) =
            make_float2(o[0], o[1]);
      if (g + 8 < nq)
        *reinterpret_cast<float2*>(dv + (out0 + static_cast<long long>(g + 8) * H) * HD + col) =
            make_float2(o[2], o[3]);
    }
    if (chan) {
      const int i = ch;
      float wv[kL], rv[kL], kv[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        wv[t] = cw[t * F + i];
        rv[t] = widen(cr[t * PT + i]);
        kv[t] = widen(ck[t * PT + i]);
      }
      const float ui = sU[i];
      if (grp == 0) {  // dr
        // dr_t = rho_t PD_t + sum_{s<t} pi(s,t) k_s M[t,s] + u k_t M[t,t]; dw's
        // rho_t sigma_t rowsum(P * D) + rho_t sum_{s>t} pi(t,s) r_s PD_s; du
        float rho[kL], sig[kL], acc[kL];
        rho[0] = 1.0f;
#pragma unroll
        for (int t = 1; t < kL; ++t) rho[t] = __fmul_rn(rho[t - 1], wv[t - 1]);
        sig[kL - 1] = 1.0f;
#pragma unroll
        for (int t = kL - 2; t >= 0; --t) sig[t] = __fmul_rn(sig[t + 1], wv[t + 1]);
#pragma unroll
        for (int t = 0; t < kL; ++t) acc[t] = __fmul_rn(rho[t], sPD[t * F + i]);
#pragma unroll
        for (int s = 0; s < kL - 1; ++s) {
          float kf = kv[s];
#pragma unroll
          for (int t = s + 1; t < kL; ++t) {
            acc[t] = __fmaf_rn(sM[t * AP + s], kf, acc[t]);
            kf = __fmul_rn(kf, wv[t]);
          }
        }
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          const float mtt = sM[t * AP + t];
          acc[t] = __fmaf_rn(__fmul_rn(ui, kv[t]), mtt, acc[t]);
          du_acc = __fmaf_rn(__fmul_rn(rv[t], kv[t]), mtt, du_acc);
          if (t < nq) dr[(out0 + static_cast<long long>(t) * H) * HD + i] = acc[t];
        }
        const float rdi = sRD[i];
        float cc = 0.0f;
#pragma unroll
        for (int t = kL - 1; t >= 0; --t) {
          xw[t] = __fmaf_rn(__fmul_rn(rho[t], sig[t]), rdi, __fmul_rn(rho[t], cc));
          cc = __fmaf_rn(wv[t], cc, __fmul_rn(rv[t], sPD[t * F + i]));
        }
      }
      if (grp == 1) {  // dk
        // dk_t = sigma_t GV_t + sum_{s>t} pi(t,s) r_s M[s,t] + r_t u M[t,t];
        // dw's sigma_t sum_{s<t} pi(s,t) k_s GV_s
        float sig[kL], acc[kL];
        sig[kL - 1] = 1.0f;
#pragma unroll
        for (int t = kL - 2; t >= 0; --t) sig[t] = __fmul_rn(sig[t + 1], wv[t + 1]);
#pragma unroll
        for (int t = 0; t < kL; ++t) acc[t] = __fmul_rn(sig[t], sGV[t * F + i]);
#pragma unroll
        for (int s = kL - 1; s > 0; --s) {
          float rf = rv[s];
#pragma unroll
          for (int t = s - 1; t >= 0; --t) {
            acc[t] = __fmaf_rn(sM[s * AP + t], rf, acc[t]);
            rf = __fmul_rn(rf, wv[t]);
          }
        }
        float bb = 0.0f;
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          acc[t] = __fmaf_rn(__fmul_rn(rv[t], ui), sM[t * AP + t], acc[t]);
          if (t < nq) dk[(out0 + static_cast<long long>(t) * H) * HD + i] = acc[t];
          sDW[t * F + i] = __fmul_rn(sig[t], bb);
          bb = __fmaf_rn(wv[t], bb, __fmul_rn(kv[t], sGV[t * F + i]));
        }
      }
      if (grp == 2) {  // dw's last term
        // dw's sum_{s<t<s'} pi(s,t) pi(t,s') k_s r_s' M[s',s], through
        // del_t[s'] = sum_{s<t} pi(s,t) k_s M[s',s] carried forward in t
        float del[kL];
#pragma unroll
        for (int s = 0; s < kL; ++s) del[s] = 0.0f;
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          float acc = 0.0f, p = 1.0f;
#pragma unroll
          for (int s2 = t + 1; s2 < kL; ++s2) {
            acc = __fmaf_rn(__fmul_rn(p, rv[s2]), del[s2], acc);
            p = __fmul_rn(p, wv[s2]);
          }
          sDW[kL * F + t * F + i] = acc;
#pragma unroll
          for (int s2 = t + 2; s2 < kL; ++s2)
            del[s2] = __fmaf_rn(kv[t], sM[s2 * AP + t], __fmul_rn(wv[t], del[s2]));
        }
      }
    }
    // P carried to the next sub-chunk, P = E * P + (k * sigma)^T v, by the
    // warps past the groups (nothing in this phase reads sP)
    constexpr int kFree = 3 * GS / 32;  // the first warp past the groups
    if (qs + 1 < nsub && warp >= kFree) {
      __syncwarp();
#pragma unroll 1
      for (int unit = warp - kFree; unit < MT * NT / 2; unit += kWarps - kFree) {  // the P carry
        const int mt = unit / (NT / 2), j0 = unit % (NT / 2) * 2, i0 = mt * 16 + g;
        const float ea = sE[i0], eb = sE[i0 + 8];
        float d[2][3][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = (j0 + jj) * 8 + 2 * q;
          d[jj][0][0] = __fmul_rn(sP[i0 * PS + col], ea);
          d[jj][0][1] = __fmul_rn(sP[i0 * PS + col + 1], ea);
          d[jj][0][2] = __fmul_rn(sP[(i0 + 8) * PS + col], eb);
          d[jj][0][3] = __fmul_rn(sP[(i0 + 8) * PS + col + 1], eb);
#pragma unroll
          for (int x = 0; x < 4; ++x) d[jj][1][x] = d[jj][2][x] = 0.0f;
        }
#pragma unroll
        for (int ks = 0; ks < kL / 8; ++ks) {
          uint32_t ah[4], al[4];
          a_cols<F, false>(sKh, mt * 16, ks * 8, g, q, ah, al);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t bh2[2], bl2[2];
            b_kn<PT, kX>(cv, ks * 8, (j0 + jj) * 8, g, q, bh2, bl2);
            mma3<false, kX>(d[jj], ah, al, bh2, bl2);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = (j0 + jj) * 8 + 2 * q;
          sP[i0 * PS + col] = sum3(d[jj], 0);
          sP[i0 * PS + col + 1] = sum3(d[jj], 1);
          sP[(i0 + 8) * PS + col] = sum3(d[jj], 2);
          sP[(i0 + 8) * PS + col + 1] = sum3(d[jj], 3);
        }
      }
    }
    dw_out0 = out0;
    dw_n = nq;
  }
  __syncthreads();
  write_dw();
  if (chan && grp == 0) du_part[(static_cast<long long>(bh) * C + c) * HD + ch] = du_acc;
}

template <typename F>
int by_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The shared-memory opt-in of the two kernels of one instantiation, once.
template <typename TIn, int HD>
cudaError_t opt_in() {
  static bool ready = false;
  if (ready) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(wkv6_bwd_kernel<TIn, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Chunk<TIn, HD>::bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_bwd_states_kernel<TIn, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(States<TIn, HD>::bytes));
  ready = e == cudaSuccess;
  return e;
}

// registers per thread, dynamic and static shared bytes per CTA, resident
// CTAs per SM of one kernel
template <typename K>
cudaError_t info_of(K kernel, int threads, size_t dyn, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, dyn);
  out[0] = e == cudaSuccess ? a.numRegs : 0;
  out[1] = static_cast<int>(dyn);
  out[2] = e == cudaSuccess ? static_cast<int>(a.sharedSizeBytes) : 0;
  out[3] = blocks;
  return e;
}

}  // namespace

// Launch 1.  r, k, v: (B, S, H, hd), bf16 if rkv_bf16 else f32; w, dy: (B, S,
// H, hd) f32; s0: (B, H, hd, hd) f32; dsT: the same or null (zero).  Writes
// Pscr, Gscr (B, H, C, hd, hd), C = ceil(S / chunk): the state before each
// chunk and the gradient of the state after it, and ds0 (B, H, hd, hd), f32.
// chunk must be the kernels' kC (64).  Every array contiguous; hd in {16,
// 32, 64, 80}; S >= 1.
extern "C" int wkv6_bwd_states_launch(const void* r, const void* k, const void* v,
                                      const float* w, const float* s0, const float* dy,
                                      const float* dsT, float* Pscr, float* Gscr, float* ds0,
                                      int B, int S, int H, int hd, int rkv_bf16, int chunk,
                                      cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk != kC) return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto tin, auto c) -> int {
    using T = decltype(tin);
    constexpr int HD = decltype(c)::value;
    const cudaError_t e = opt_in<T, HD>();
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv6_bwd_states_kernel<T, HD><<<B * H * 2, States<T, HD>::NT, States<T, HD>::bytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, s0, dy,
        dsT, Pscr, Gscr, ds0, S, H);
    return static_cast<int>(cudaGetLastError());
  };
  return by_hd(hd, [&](auto c) {
    return rkv_bf16 ? go(__nv_bfloat16(0.0f), c) : go(0.0f, c);
  });
}

// Launch 2.  r, k, v, w, dy as above (each 16-byte aligned); u: (H, hd) f32;
// Pscr, Gscr from launch 1.  Writes dr, dk, dv, dw (B, S, H, hd) and du_part
// (B, H, C, hd) (to be summed over B and C), f32.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* w,
                               const float* u, const float* dy, const float* Pscr,
                               const float* Gscr, float* dr, float* dk, float* dv, float* dw,
                               float* du_part, int B, int S, int H, int hd, int rkv_bf16,
                               int chunk, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0 || chunk != kC) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = B * H * ((S + kC - 1) / kC);
  auto go = [&](auto tin, auto c) -> int {
    using T = decltype(tin);
    constexpr int HD = decltype(c)::value;
    const cudaError_t e = opt_in<T, HD>();
    if (e != cudaSuccess) return static_cast<int>(e);
    wkv6_bwd_kernel<T, HD><<<grid, kThreads, Chunk<T, HD>::bytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, dy,
        Pscr, Gscr, dr, dk, dv, dw, du_part, S, H);
    return static_cast<int>(cudaGetLastError());
  };
  return by_hd(hd, [&](auto c) {
    return rkv_bf16 ? go(__nv_bfloat16(0.0f), c) : go(0.0f, c);
  });
}

// out[0..3]: registers per thread, dynamic shared bytes, static shared bytes
// per CTA and resident CTAs per SM of wkv6_bwd; out[4..7] the same of
// wkv6_bwd_states.
extern "C" int wkv6_bwd_info(int hd, int rkv_bf16, int* out) {
  auto go = [&](auto tin, auto c) -> int {
    using T = decltype(tin);
    constexpr int HD = decltype(c)::value;
    cudaError_t e = opt_in<T, HD>();
    if (e == cudaSuccess) e = info_of(wkv6_bwd_kernel<T, HD>, kThreads, Chunk<T, HD>::bytes, out);
    if (e == cudaSuccess)
      e = info_of(wkv6_bwd_states_kernel<T, HD>, States<T, HD>::NT, States<T, HD>::bytes, out + 4);
    return static_cast<int>(e);
  };
  return by_hd(hd, [&](auto c) {
    return rkv_bf16 ? go(__nv_bfloat16(0.0f), c) : go(0.0f, c);
  });
}
