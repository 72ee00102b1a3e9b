// WKV6 recurrence (the RWKV6 time mix) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/wkv6.py::wkv6_chunked (_wkv_kernel).
// Per head (b, h), with the state S (hd x hd, f32) carried across time:
//   y_t = r_t^T S + (sum_i r_t[i] u[i] k_t[i]) v_t
//   S   = w_t (.)rows S + k_t v_t^T
// r, k, v, w are read in place in the model's (B, S, H, hd) layout: head
// (b, h) at time t is hd contiguous elements at ((b*S + t)*H + h)*hd.  r, k
// and v are bf16 or f32 and are widened, which is exact; w, u and s0 are
// f32; y (B, S, H, hd) and sT (B, H, hd, hd) are written as f32.  No padding
// of S and no relayout copies.  hd is a template parameter: 16, 32, 64, 80.
// Two designs, one launch each; the wrapper (ops.wkv6) takes the chunked one
// when S holds at least one chunk (prefill) and the recurrent one otherwise
// (decode, S = 1).
//
// The recurrent design (decode).  One CTA of 32*ceil(hd/32) threads per
// (b, h); thread j owns column j of S in registers and walks time; chunks of
// kT steps of r, k, v, w are staged into shared memory with cp.async,
// double buffered.  Every product and sum is its own __fmul_rn / __fadd_rn
// (and the build passes --fmad=false), so each step of S rounds as the plain
// version's `w * S + kv` does and sT agrees with it bit for bit.  It spends
// 7 hd^2 operations per step (u*kv for every (i, j)) and has no parallelism
// over time: at S = 1 its cost is one read and one write of S.
//
// The chunked design (prefill), the form FLA uses for RWKV6 and GLA.  Per
// chunk of kC = 32 steps, two sub-chunks of kL = 16, with a = max(log2 w,
// -100) summed along each sub-chunk (G inclusive, G[t-1] exclusive, T the
// total):
//   R[t] = r_t * 2^G[t-1],  K[s] = k_s * 2^(T - G[s]),  E = 2^T  (per sub-chunk)
//   y(sub 0) = R0 S + A00 V0
//   y(sub 1) = R1 (E0 * S) + A10 V0 + A11 V1,  A10 = R1 K0^T  (factored through step 15)
//   App[t][s] = sum_i r_t k_s prod_{s<tau<t} max(w_tau, 2^-100) (s < t),
//   App[t][t] = sum_i r_t u k_t
//   S <- E1 * (E0 * S + K0^T V0) + K1^T V1
// Every exponent is <= 0, so nothing overflows whatever the decay (w = 0 is
// 2^-100, w = 1 is exact).  The products R S, R1 K0^T, A V and K^T V run on
// the tensor cores as mma.sync m16n8k8 TF32 in 3xTF32 (each f32 operand split
// into a TF32 high part and remainder; hi*hi + hi*lo + lo*hi, accumulated in
// f32), so they keep f32-level accuracy; a widened bf16 v is exact in TF32,
// so its products take 2 MMAs.  The diagonal blocks App are element by
// element on the CUDA cores (running products of w along t), with explicit
// __fmaf_rn: the file keeps the global --fmad=false for the recurrent kernel,
// and the chunked one gets its fused multiply-adds from the intrinsic and the
// MMAs.  log2 is __log2f (lg2.approx, about 2^-22 absolute error).  Sums run
// in another order than the plain scan's and exp2/log2 round, so sT is not
// bitwise on this path: it is held within rtol 1e-4 / atol 1e-5 x max|sT|, y
// within rtol 3e-4 / atol 3e-5 (ref.wkv6_chunked repeats this arithmetic).
//
// Bound: at the prefill shape (8, 1024, 32, 80) bf16 the function moves
// 306.7 MB (0.0916 ms at 3.35 TB/s) and needs 8.49 GFLOP, 0.017 ms at the
// 495 TFLOP/s of TF32 (0.127 ms at the 67 TFLOP/s of the CUDA cores): bytes.
// The time axis is serial only from chunk to chunk, so each CTA walks its
// head's chunks and the card's parallelism is the 256 heads times the work
// inside a chunk.  That work is many small fragment products whose cost is
// in issuing instructions and moving fragments through shared memory, not in
// the tensor cores: the TF32 split is done with integer operations (round
// half away, as cvt.rna.tf32 rounds), which run at the full rate where the
// conversion does not; a unit of the state update splits its K^T fragments
// once for two tiles; each warp keeps several independent accumulator chains
// (the three passes of 3xTF32 and, in the state update, the two sub-chunks
// apart) and issues them interleaved (`python -m repro_torch.kernels.probe`
// times the products and each phase).  One CTA of 8 warps per (b, h);
// three barriers per chunk (chunk landed, R/K/E ready, A ready); warp w takes
// y tiles w, w+8, w+16 (16 rows x 8 columns, all of one sub-chunk), the
// units of S (16 rows x 16 columns) w, w+8, ..., and the pairs of
// diagonal-block columns (w, w + 8) of both sub-chunks.
// Shared memory per CTA (dynamic): r, k, v double-buffered (2 x 32 x hd x 2
// B for bf16), w double-buffered (2 x 32 x hd x 4 B), S (hd x (hd+8) x 4 B),
// R and K (32 x (hd+4) x 4 B each), A (32 x 36 x 4 B), 2^T0, 2^T1, u: at hd
// 80 bf16 30,720 + 20,480 + 28,160 + 21,504 + 4,608 + 960 = 106,432 bytes,
// so two CTAs (with 1 KB reserved each) fit the SM's 228 KB and the 256
// heads of the prefill run in one wave on 132 SMs (264 slots);
// __launch_bounds__(256, 2) caps registers at 128 per thread (2 x 256 x 128
// = the SM's 65,536), which the design fits without spilling at hd 80 bf16
// (chip_smoke.py prints what ptxas and the occupancy calculator give).  The
// pitches (hd+4 for operands read as A, hd+8 for S read as B, 36 for A) keep
// fragment loads free of bank conflicts.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The chunked path (prefill): chunks of kC = 32 steps, two sub-chunks of kL
// = 16, 256 threads (8 warps) per (b, h).
// ---------------------------------------------------------------------------

constexpr int kC = 32;                 // steps per chunk
constexpr int kL = 16;                 // steps per sub-chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2Floor = -100.0f;  // ref.WKV6_LOG2_FLOOR
constexpr float kWFloor = 0x1p-100f;   // 2^kLog2Floor: w is taken as max(w, 2^-100)

template <typename TIn, int HD>
struct Chunked {
  static constexpr int P = HD + 4;    // pitch of R and K: A-operand rows, conflict-free
  static constexpr int PS = HD + 8;   // pitch of S: B-operand rows (k = i), conflict-free
  static constexpr int PA = kC + 4;   // pitch of A
  static constexpr int NT = HD / 8;   // n-tiles of 8 columns of S and y
  static constexpr int MT = HD / 16;  // m-tiles of 16 rows of S
  static constexpr int KS = HD / 8;   // k-steps of 8 over the channels
  static constexpr int YT = 2 * NT;   // 16 x 8 tiles of y per chunk (tile y: m = y % 2, j = y / 2)
  static constexpr int YW = (YT + kWarps - 1) / kWarps;  // y tiles per warp, at most
  static constexpr int kRaw = kC * HD;  // elements of one staged array
  // dynamic shared memory, in this order (every part a multiple of 16 bytes)
  static constexpr size_t bytes =
      3 * 2 * kRaw * sizeof(TIn)        // r, k, v, double-buffered
      + 2 * kRaw * sizeof(float)        // w, double-buffered
      + (HD * PS + 2 * kC * P + kC * PA + 3 * HD) * sizeof(float);  // S, R, K, A, E0, E1, u
  static_assert(HD % 16 == 0, "hd must be a whole number of 16-row m-tiles");
  static_assert(kWarps % 2 == 0, "a warp's y tiles share their m");
};

// x = hi + lo, both TF32 (the 3xTF32 split: hi*hi + hi*lo + lo*hi keeps
// about 21 bits of each product; lo*lo, below 2^-21 of it, is dropped).  hi
// is x rounded to TF32 half away from zero, as cvt.rna.tf32.f32 rounds, lo
// the exact remainder cut to TF32; both with integer operations, which run
// at the full rate where the conversion instruction does not.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}
// d += a * b, one m16n8k8 TF32 product with f32 accumulation.  Fragments
// (g = lane / 4, q = lane % 4): a = A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4];
// b = B[q][g], B[q+4][g]; d = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
// Not volatile, so independent products can be interleaved: the callers
// issue the three passes of 3xTF32 over all their tiles in turn, never three
// dependent products in a row.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows m0.. and columns k0.. of a row-major [rows][PITCH]
// f32 tile, split.
template <int PITCH>
__device__ __forceinline__ void a_rows(const float* t, int m0, int k0, int g, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(t[(m0 + g) * PITCH + k0 + q], hi[0], lo[0]);
  split(t[(m0 + g + 8) * PITCH + k0 + q], hi[1], lo[1]);
  split(t[(m0 + g) * PITCH + k0 + q + 4], hi[2], lo[2]);
  split(t[(m0 + g + 8) * PITCH + k0 + q + 4], hi[3], lo[3]);
}
// The A fragment of the transpose of rows k0.. and columns m0.. of a
// row-major [rows][PITCH] f32 tile (A[m][k] = t[k][m]), split.
template <int PITCH>
__device__ __forceinline__ void a_cols(const float* t, int m0, int k0, int g, int q,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(t[(k0 + q) * PITCH + m0 + g], hi[0], lo[0]);
  split(t[(k0 + q) * PITCH + m0 + g + 8], hi[1], lo[1]);
  split(t[(k0 + q + 4) * PITCH + m0 + g], hi[2], lo[2]);
  split(t[(k0 + q + 4) * PITCH + m0 + g + 8], hi[3], lo[3]);
}
// The B fragment of rows k0.. and columns n0.. of a row-major [rows][HD]
// staged tile of v (B[k][n] = v[k][n]), split; a widened bf16 (kExact) is
// its own TF32 high part and lo is left unset.
template <int HD, bool kExact, typename TIn>
__device__ __forceinline__ void b_v(const TIn* v, int k0, int n0, int g, int q,
                                    uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float x0 = widen(v[(k0 + q) * HD + n0 + g]), x1 = widen(v[(k0 + q + 4) * HD + n0 + g]);
  if (kExact) {
    hi[0] = __float_as_uint(x0);
    hi[1] = __float_as_uint(x1);
  } else {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
  }
}

// This lane's share (channels lane, lane + 32, ...) of columns sl and sl + 8
// (sl < 8) of sub-chunk p's diagonal block: acc[tt] for column sl, acc[16 +
// tt] for column sl + 8, over rows tt; r_t (k_s prod_{s < tau < t}
// max(w_tau, 2^-100)) below the diagonal, r_s (k_s u) on it, nothing above.
// The sub-chunk's r and w are loaded once for both columns, so the two
// running products are the only chains.
template <int HD, typename TIn>
__device__ __forceinline__ void diag_columns(const TIn* cr, const TIn* ck, const float* cw,
                                             const float* sU, int p, int sl, int lane,
                                             float (&acc)[2 * kL]) {
  for (int i = lane; i < HD; i += 32) {
    float rv[kL], wv[kL];
#pragma unroll
    for (int tt = 0; tt < kL; ++tt) {
      rv[tt] = widen(cr[(p * kL + tt) * HD + i]);
      wv[tt] = fmaxf(cw[(p * kL + tt) * HD + i], kWFloor);
    }
    const float us = sU[i];
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int sz = sl + z * (kL / 2);
      float kf = widen(ck[(p * kL + sz) * HD + i]);  // k_s prod_{s < tau < t} w_tau
#pragma unroll
      for (int tt = z * (kL / 2); tt < kL; ++tt) {
        if (tt == sz) acc[z * kL + tt] = __fmaf_rn(rv[tt], __fmul_rn(kf, us), acc[z * kL + tt]);
        if (tt > sz) {
          acc[z * kL + tt] = __fmaf_rn(rv[tt], kf, acc[z * kL + tt]);
          kf = __fmul_rn(kf, wv[tt]);
        }
      }
    }
  }
}

// One step of the butterfly that sums 32 values over the 32 lanes of a warp:
// a lane keeps the half of its values that bit O of its lane picks and adds
// the partner's copy of that half.  After steps 16, 8, 4, 2, 1 lane l holds
// the sum of value l.
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
__global__ void __launch_bounds__(kThreads, 2)
wkv6_chunked_kernel(const TIn* __restrict__ r, const TIn* __restrict__ k,
                    const TIn* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ sT, int S, int H) {
  using CF = Chunked<TIn, HD>;
  constexpr int P = CF::P, PS = CF::PS, PA = CF::PA, RAW = CF::kRaw;
  constexpr bool kVExact = sizeof(TIn) == 2;  // a widened bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char smem[];
  TIn* sr = reinterpret_cast<TIn*>(smem);  // [2][kC][HD]
  TIn* sk = sr + 2 * RAW;
  TIn* sv = sk + 2 * RAW;
  float* sw = reinterpret_cast<float*>(sv + 2 * RAW);  // [2][kC][HD]
  float* sS = sw + 2 * RAW;     // [HD][PS] the state
  float* sR = sS + HD * PS;     // [kC][P]  r * 2^(exclusive prefix)
  float* sK = sR + kC * P;      // [kC][P]  k * 2^(sub-chunk total - inclusive prefix)
  float* sA = sK + kC * P;      // [kC][PA] intra-chunk scores
  float* sE0 = sA + kC * PA;    // [HD] 2^T0
  float* sE1 = sE0 + HD;        // [HD] 2^T1
  float* sU = sE1 + HD;         // [HD] u

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int my_m = warp % 2;  // the m-tile (sub-chunk) of this warp's y tiles
  const long long state0 = static_cast<long long>(bh) * HD * HD;
  for (int e = tid; e < HD * HD; e += kThreads) sS[(e / HD) * PS + e % HD] = s0[state0 + e];
  for (int i = tid; i < HD; i += kThreads) sU[i] = u[h * HD + i];

  const int chunks = (S + kC - 1) / kC;
  auto issue = [&](int c) {
    const int buf = c & 1, n = min(kC, S - c * kC);
    const long long row0 = (static_cast<long long>(b) * S + c * kC) * H + h;
    stage<TIn, HD, kThreads>(sr + buf * RAW, r, row0, H, n);
    stage<TIn, HD, kThreads>(sk + buf * RAW, k, row0, H, n);
    stage<TIn, HD, kThreads>(sv + buf * RAW, v, row0, H, n);
    stage<float, HD, kThreads>(sw + buf * RAW, w, row0, H, n);
    cp_async_commit();
  };
  issue(0);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1, n = min(kC, S - c * kC);
    TIn* cr = sr + buf * RAW;
    TIn* ck = sk + buf * RAW;
    TIn* cv = sv + buf * RAW;
    float* cw = sw + buf * RAW;
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c-1
    if (c + 1 < chunks) issue(c + 1);  // into the buffer chunk c-1 used
    if (n < kC) {  // the ragged tail: r = k = v = 0 and w = 1 past the end
      for (int e = tid; e < (kC - n) * HD; e += kThreads) {
        const int o = n * HD + e;
        cr[o] = ck[o] = cv[o] = TIn(0.0f);
        cw[o] = 1.0f;
      }
      __syncthreads();
    }

    // Phase 1, one thread per (sub-chunk, channel): a = max(log2 w, -100)
    // summed along the sub-chunk (G), R = r * 2^G[t-1], E = 2^T and
    // K = k * 2^(T - G[s]).  Every exponent is <= 0.
    for (int e = tid; e < 2 * HD; e += kThreads) {
      const int p = e / HD, i = e % HD, t0 = p * kL;
      float gs[kL];
#pragma unroll
      for (int tt = 0; tt < kL; ++tt) gs[tt] = fmaxf(__log2f(cw[(t0 + tt) * HD + i]), kLog2Floor);
      float cum = 0.0f;
#pragma unroll
      for (int tt = 0; tt < kL; ++tt) {
        sR[(t0 + tt) * P + i] = __fmul_rn(widen(cr[(t0 + tt) * HD + i]), exp2f(cum));
        cum = __fadd_rn(cum, gs[tt]);
        gs[tt] = cum;
      }
      (p == 0 ? sE0 : sE1)[i] = exp2f(cum);
#pragma unroll
      for (int tt = 0; tt < kL; ++tt)
        sK[(t0 + tt) * P + i] = __fmul_rn(widen(ck[(t0 + tt) * HD + i]),
                                          exp2f(__fsub_rn(cum, gs[tt])));
    }

    // Phase 2a, the diagonal blocks of A, one warp per pair of columns (sub-
    // chunk p, steps sl and sl + 8), lanes over the channels: A[t][s] = sum_i
    // r_t k_s prod_{s < tau < t} max(w_tau, 2^-100) for s < t (the running
    // product along t), A[s][s] = sum_i r_s k_s u, A[t][s] = 0 above the
    // diagonal; the 32 sums are then reduced over the lanes in one butterfly.
    for (int task = warp; task < kL; task += kWarps) {
      const int p = task / (kL / 2), sl = task % (kL / 2);
      float acc[2 * kL];
#pragma unroll
      for (int z = 0; z < 2 * kL; ++z) acc[z] = 0.0f;
      diag_columns<HD>(cr, ck, cw, sU, p, sl, lane, acc);
      reduce_step<16>(acc, lane);
      reduce_step<8>(acc, lane);
      reduce_step<4>(acc, lane);
      reduce_step<2>(acc, lane);
      reduce_step<1>(acc, lane);
      sA[(p * kL + lane % kL) * PA + p * kL + sl + lane / kL * (kL / 2)] = acc[0];
    }
    __syncthreads();  // R, K, E0 and E1 ready

    // The products below keep the three passes of 3xTF32 (hi*hi, hi*lo,
    // lo*hi) in separate accumulators, summed at the end, so that every warp
    // keeps several independent chains in flight and no product waits on the
    // one before it.

    // Phase 2b, the off-diagonal block (t in sub-chunk 1, s in sub-chunk 0),
    // factored through step 15: A[t][s] = R[t] . K[s], on the tensor cores,
    // one n-tile of 8 s for each of the last two warps (k-steps split in two
    // halves: six chains).
    if (warp >= kWarps - 2) {
      const int n0 = (warp - (kWarps - 2)) * 8;
      float d[2][3][4] = {};
#pragma unroll 1
      for (int k0 = 0; k0 < CF::KS; k0 += 2) {
#pragma unroll
        for (int z = 0; z < 2; ++z) {
          const int ks = k0 + z;
          uint32_t ah[4], al[4], bh[2], bl[2];
          a_rows<P>(sR, kL, ks * 8, g, q, ah, al);
          split(sK[(n0 + g) * P + ks * 8 + q], bh[0], bl[0]);
          split(sK[(n0 + g) * P + ks * 8 + q + 4], bh[1], bl[1]);
          mma(d[z][0], ah, bh);
          mma(d[z][1], ah, bl);
          mma(d[z][2], al, bh);
        }
      }
      float* a = sA + (kL + g) * PA + n0 + 2 * q;
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __fadd_rn(__fadd_rn(d[0][0][e], d[1][0][e]),
                         __fadd_rn(__fadd_rn(d[0][1][e], d[1][1][e]),
                                   __fadd_rn(d[0][2][e], d[1][2][e])));
      a[0] = o[0];
      a[1] = o[1];
      a[8 * PA] = o[2];
      a[8 * PA + 1] = o[3];
    }

    // Phase 2c, the state term on this warp's y tiles (m = my_m, j =
    // tile / 2): rows of sub-chunk 0 against S, rows of sub-chunk 1 against
    // 2^T0 * S.
    float acc[CF::YW][3][4];
#pragma unroll
    for (int x = 0; x < CF::YW; ++x)
#pragma unroll
      for (int z = 0; z < 3; ++z)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[x][z][e] = 0.0f;
#pragma unroll 2
    for (int ks = 0; ks < CF::KS; ++ks) {
      uint32_t ah[4], al[4], bh[CF::YW][2], bl[CF::YW][2];
      a_rows<P>(sR, my_m * kL, ks * 8, g, q, ah, al);
      const float e0 = my_m ? sE0[ks * 8 + q] : 1.0f, e1 = my_m ? sE0[ks * 8 + q + 4] : 1.0f;
#pragma unroll
      for (int x = 0; x < CF::YW; ++x) {
        const int j = (warp + kWarps * x) / 2;
        if (warp + kWarps * x < CF::YT) {
          split(__fmul_rn(sS[(ks * 8 + q) * PS + j * 8 + g], e0), bh[x][0], bl[x][0]);
          split(__fmul_rn(sS[(ks * 8 + q + 4) * PS + j * 8 + g], e1), bh[x][1], bl[x][1]);
        }
      }
#pragma unroll
      for (int x = 0; x < CF::YW; ++x)
        if (warp + kWarps * x < CF::YT) mma(acc[x][0], ah, bh[x]);
#pragma unroll
      for (int x = 0; x < CF::YW; ++x)
        if (warp + kWarps * x < CF::YT) mma(acc[x][1], ah, bl[x]);
#pragma unroll
      for (int x = 0; x < CF::YW; ++x)
        if (warp + kWarps * x < CF::YT) mma(acc[x][2], al, bh[x]);
    }
    __syncthreads();  // A complete; every warp done reading S

    // Phase 3a, y += A V on this warp's y tiles (sub-chunk 0 rows see s <
    // 16, sub-chunk 1 rows all 32), stored.
#pragma unroll 2
    for (int ks = 0; ks < 2 * (my_m + 1); ++ks) {
      uint32_t ah[4], al[4], bh[CF::YW][2], bl[CF::YW][2];
      a_rows<PA>(sA, my_m * kL, ks * 8, g, q, ah, al);
#pragma unroll
      for (int x = 0; x < CF::YW; ++x)
        if (warp + kWarps * x < CF::YT)
          b_v<HD, kVExact>(cv, ks * 8, (warp + kWarps * x) / 2 * 8, g, q, bh[x], bl[x]);
#pragma unroll
      for (int x = 0; x < CF::YW; ++x)
        if (warp + kWarps * x < CF::YT) mma(acc[x][0], ah, bh[x]);
      if (!kVExact) {
#pragma unroll
        for (int x = 0; x < CF::YW; ++x)
          if (warp + kWarps * x < CF::YT) mma(acc[x][1], ah, bl[x]);
      }
#pragma unroll
      for (int x = 0; x < CF::YW; ++x)
        if (warp + kWarps * x < CF::YT) mma(acc[x][2], al, bh[x]);
    }
#pragma unroll
    for (int x = 0; x < CF::YW; ++x) {
      if (warp + kWarps * x >= CF::YT) continue;
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __fadd_rn(acc[x][0][e], __fadd_rn(acc[x][1][e], acc[x][2][e]));
      const int t = my_m * kL + g, col = (warp + kWarps * x) / 2 * 8 + 2 * q;
      const long long row = (static_cast<long long>(b) * S + c * kC + t) * H + h;
      if (t < n) *reinterpret_cast<float2*>(y + row * HD + col) = make_float2(o[0], o[1]);
      if (t + 8 < n)
        *reinterpret_cast<float2*>(y + (row + 8LL * H) * HD + col) = make_float2(o[2], o[3]);
    }

    // Phase 3b, the state carried sub-chunk by sub-chunk, S <- 2^T1 * (2^T0 *
    // S + K0^T V0) + K1^T V1, one unit (an m-tile of 16 rows of S, two n-tiles
    // of 8 columns) at a time: the unit's K^T fragments are split once for
    // both tiles; the two sub-chunks' products go to separate accumulators
    // (so do the hi*hi products and the corrections): eight chains of two
    // products per unit.
#pragma unroll 1
    for (int unit = warp; unit < CF::MT * CF::NT / 2; unit += kWarps) {
      const int mt = unit / (CF::NT / 2), j0 = unit % (CF::NT / 2) * 2, i0 = mt * 16 + g;
      uint32_t ah[4][4], al[4][4];  // A[i][s] = K[s][i], k-steps 0..3
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) a_cols<P>(sK, mt * 16, ks * 8, g, q, ah[ks], al[ks]);
      const float ea = sE0[i0], eb = sE0[i0 + 8], fa = sE1[i0], fb = sE1[i0 + 8];
      float d[2][2][2][4];  // [tile][sub-chunk][hi*hi, corrections]
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = (j0 + jj) * 8 + 2 * q;
        d[jj][0][0][0] = __fmul_rn(sS[i0 * PS + col], ea);
        d[jj][0][0][1] = __fmul_rn(sS[i0 * PS + col + 1], ea);
        d[jj][0][0][2] = __fmul_rn(sS[(i0 + 8) * PS + col], eb);
        d[jj][0][0][3] = __fmul_rn(sS[(i0 + 8) * PS + col + 1], eb);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[jj][0][1][e] = d[jj][1][0][e] = d[jj][1][1][e] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t bh[2][2][2], bl[2][2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int z = 0; z < 2; ++z)  // k-step kk of sub-chunk z
            b_v<HD, kVExact>(cv, (2 * z + kk) * 8, (j0 + jj) * 8, g, q, bh[jj][z], bl[jj][z]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int z = 0; z < 2; ++z) mma(d[jj][z][0], ah[2 * z + kk], bh[jj][z]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int z = 0; z < 2; ++z) mma(d[jj][z][1], al[2 * z + kk], bh[jj][z]);
        if (!kVExact) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int z = 0; z < 2; ++z) mma(d[jj][z][1], ah[2 * z + kk], bl[jj][z]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = (j0 + jj) * 8 + 2 * q;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = __fadd_rn(__fmul_rn(__fadd_rn(d[jj][0][0][e], d[jj][0][1][e]), e < 2 ? fa : fb),
                           __fadd_rn(d[jj][1][0][e], d[jj][1][1][e]));
        sS[i0 * PS + col] = o[0];
        sS[i0 * PS + col + 1] = o[1];
        sS[(i0 + 8) * PS + col] = o[2];
        sS[(i0 + 8) * PS + col + 1] = o[3];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < HD * HD; e += kThreads) sT[state0 + e] = sS[(e / HD) * PS + e % HD];
}

template <typename TIn, int HD>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           const float* s0, float* y, float* sT, int B, int S, int H, int chunked,
           cudaStream_t stream) {
  const TIn *rr = static_cast<const TIn*>(r), *kk = static_cast<const TIn*>(k),
            *vv = static_cast<const TIn*>(v);
  if (!chunked) {
    wkv6_kernel<TIn, HD><<<B * H, threads_for<HD>(), 0, stream>>>(rr, kk, vv, w, u, s0, y, sT,
                                                                  S, H);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr size_t bytes = Chunked<TIn, HD>::bytes;
  static bool ready = false;  // the shared-memory opt-in, once per instantiation
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(wkv6_chunked_kernel<TIn, HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  wkv6_chunked_kernel<TIn, HD><<<B * H, kThreads, bytes, stream>>>(rr, kk, vv, w, u, s0, y,
                                                                   sT, S, H);
  return static_cast<int>(cudaGetLastError());
}

// registers per thread, dynamic and static shared bytes per CTA, resident
// CTAs per SM of the chunked kernel
template <typename TIn, int HD>
int info(int* out) {
  constexpr size_t bytes = Chunked<TIn, HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(wkv6_chunked_kernel<TIn, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, wkv6_chunked_kernel<TIn, HD>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_chunked_kernel<TIn, HD>,
                                                      kThreads, bytes);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(bytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = blocks;
  return static_cast<int>(e);
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

template <typename TIn>
int launch_hd(int hd, const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, float* y, float* sT, int B, int S, int H,
              int chunked, cudaStream_t stream) {
  return by_hd(hd, [&](auto c) {
    return launch<TIn, decltype(c)::value>(r, k, v, w, u, s0, y, sT, B, S, H, chunked, stream);
  });
}

}  // namespace

// r, k, v: (B, S, H, hd), bf16 if rkv_bf16 else f32; w: (B, S, H, hd) f32;
// u: (H, hd) f32; s0: (B, H, hd, hd) f32.  Writes y (B, S, H, hd) and sT
// (B, H, hd, hd), f32, through the chunked design if `chunked`, else the
// recurrent one.  Every pointer 16-byte aligned, every array contiguous; hd
// in {16, 32, 64, 80}; S >= 1.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const float* w,
                           const float* u, const float* s0, float* y, float* sT, int B, int S,
                           int H, int hd, int rkv_bf16, int chunked, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return rkv_bf16
             ? launch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, sT, B, S, H, chunked, stream)
             : launch_hd<float>(hd, r, k, v, w, u, s0, y, sT, B, S, H, chunked, stream);
}

// out[0..3]: registers per thread, dynamic shared bytes per CTA, static
// shared bytes per CTA, resident CTAs per SM of the chunked kernel.
extern "C" int wkv6_chunked_info(int hd, int rkv_bf16, int* out) {
  auto f = [&](auto c) {
    return rkv_bf16 ? info<__nv_bfloat16, decltype(c)::value>(out)
                    : info<float, decltype(c)::value>(out);
  };
  return by_hd(hd, f);
}
