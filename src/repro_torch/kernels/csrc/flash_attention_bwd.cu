// Hand-written Hopper kernels for the backward pass of causal and
// sliding-window attention with grouped (GQA/MQA) key-value heads: the
// gradient of kernels/csrc/flash_attention.cu's function, for training.
// Built by nvcc into a plain-C shared library and bound with ctypes (see
// kernels/_build.py).
//
// Every kernel is a template on the forward's head-dim pair <DQK, DV>: q, k,
// dq and dk have DQK columns, v, o, dO and dv DV.  The entry point launches
// (64, 64), (128, 128), (256, 256) and DeepSeek-V2's expanded MLA, (192,
// 128), and refuses any other pair.  The scores are scaled by 1 / sqrt(DQK).
// At (192, 128) S = Q K^T and dQ = dS K sum over or write 192 columns (three
// swizzled 64-column boxes), dP = dO V^T sums over 128 and dV = P^T dO
// writes 128, dK = dS^T Q writes 192 (wgmma N = 192).
//
// No TPU kernel is replaced: the JAX package differentiates its plain-XLA
// chunked_causal_attention (repro/models/attention.py), and these kernels
// compute that gradient.  The forward's kernels write each row's
// log-sum-exp lse of its scaled scores; given q, k, v, the output o, its
// gradient dO and lse, three passes give dq, dk and dv:
//   1. the row statistics: D_i = sum_d dO_id O_id, float32;
//   2. dK, dV: one block a (batch, kv head, key tile).  It walks the
//      query heads of its group and the query tiles that may see its keys,
//      recomputes P = exp(S - lse) and accumulates dV += P^T dO and
//      dK += dS^T Q with dS = P (dO V^T - D), in float32;
//   3. dQ: one block a (batch, query head, query tile) over the key tiles
//      of its band: dQ += dS K.
// A kv head's dK and dV sum over its group's query heads in a fixed order
// and every output element is written once, so there are no atomics and
// two launches give bitwise equal results.
//
// Two routes (kernels/flash_attention.bwd_route).  bfloat16 runs on the
// tensor cores through wgmma, fed by TMA (see the section below); bound
// on the H100: operations, 2 (3 DQK + 2 DV) a visible pair (10 hd at an
// equal pair) at the bf16 tensor rate.
// float32 runs on the CUDA cores in float32: each tile is staged in shared
// memory both transposed (for the score products, which sum over hd) and
// row-major (for the accumulations, which sum over rows); a thread owns a
// small register tile of scores and one of the accumulators, and the inner
// loops read 16-byte vectors of shared memory.  Bound on the H100:
// operations (2 (3 DQK + 2 DV) a visible pair: S, dK and dQ over DQK, dP
// and dV over DV), far above the bytes.
//
// Build flags: kernels/_build.NVCC_FLAGS (-O3 --fmad=false); held to a
// tolerance against kernels/ref.py::attention_bwd_ref.  The C entry point
// launches on the caller's stream, does not synchronise, allocates nothing
// (its scratch comes from the wrapper, kernels/flash_attention.
// bwd_scratch_floats), and returns cudaGetLastError().

#include <math.h>

#include <type_traits>

#include "hopper.cuh"   // TMA, mbarriers, descriptors, wgmma, tile kinds

namespace {

constexpr int kThreads = 256;            // 16 x 16

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int skv,
                                        int causal, int window) {
  bool vis = qpos < sq && kpos < skv;
  if (causal) vis = vis && kpos <= qpos;
  if (window > 0) vis = vis && kpos > qpos - window;
  return vis;
}

// four consecutive floats (16 bytes, aligned: rows start on a multiple of
// hd elements and hd is a multiple of 64)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// R consecutive floats of shared memory (R = 2 or 4), 8- or 16-byte aligned
template <int R>
__device__ __forceinline__ void lds(float (&r)[R], const float* p) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  }
}

// Stage rows [r0, r0 + ROWS) of one head of a (B, S, heads, D) tensor into
// shared memory, transposed (tr[d * ld_t + r]) and, when rm is
// not null, row-major (rm[r * (D + 4) + d]); rows at or past s are zeros.
// A warp takes 8 rows x 16 columns: each row's 16 columns are one
// contiguous read, and the transposed stores of a warp fall in 16 banks.
template <int D, int ROWS>
__device__ __forceinline__ void stage(const float* __restrict__ src, int s,
                                      int heads, int head, int r0,
                                      float* tr, int ld_t, float* rm) {
  constexpr int kChunks = (ROWS / 8) * (D / 16);
  const long long row_stride = (long long)heads * D;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < kChunks; c += kThreads / 32) {
    const int r = (c % (ROWS / 8)) * 8 + (lane & 7);
    const int d = ((c / (ROWS / 8)) * 4 + (lane >> 3)) * 4;
    const int row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s) v = load4(src + row * row_stride + (long long)head * D + d);
    tr[(d + 0) * ld_t + r] = v.x;
    tr[(d + 1) * ld_t + r] = v.y;
    tr[(d + 2) * ld_t + r] = v.z;
    tr[(d + 3) * ld_t + r] = v.w;
    if (rm != nullptr) store4(rm + r * (D + 4) + d, v);
  }
}

// acc[i][j] += sum_c A[c * lda + i0 + i] B[c * ldb + j0 + j] for c < C:
// a thread's RI x RJ tile of a product that sums over C rows of two
// transposed tiles
template <int RI, int RJ, int C>
__device__ __forceinline__ void tile_product(float (&acc)[RI][RJ],
                                             const float* A, int lda,
                                             const float* B, int ldb) {
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    float a[RI], b[RJ];
    lds<RI>(a, A + c * lda);
    lds<RJ>(b, B + c * ldb);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) acc[i][j] += a[i] * b[j];
  }
}

// acc[i][g * 4 + e] += sum_r W[r * ldw + i0 + i]
// X[r * (D + 4) + g * 64 + x0 + e] for r < R: a thread's RI rows x (D / 16)
// columns of an accumulation over R rows, W a tile of weights (P or dS)
// and X a row-major tile
template <int RI, int D, int R>
__device__ __forceinline__ void accumulate(float (&acc)[RI][D / 16],
                                           const float* W, int ldw,
                                           const float* X) {
#pragma unroll 2
  for (int r = 0; r < R; ++r) {
    float w[RI];
    lds<RI>(w, W + r * ldw);
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 x =
          *reinterpret_cast<const float4*>(X + r * (D + 4) + g * 64);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        acc[i][g * 4 + 0] += w[i] * x.x;
        acc[i][g * 4 + 1] += w[i] * x.y;
        acc[i][g * 4 + 2] += w[i] * x.z;
        acc[i][g * 4 + 3] += w[i] * x.w;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO * O) over v's DV columns, (B, H, Sq) float32; one warp
// a (b, row, head)
// ---------------------------------------------------------------------------
template <int DV>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int batch, int sq, int heads) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * sq * heads) return;
  const float* op = o + row * DV;
  const float* dp = dout + row * DV;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < DV; d += 32) sum += op[d] * dp[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    // row = (b * sq + s) * heads + h -> (b * heads + h) * sq + s
    const long long h = row % heads;
    const long long bs = row / heads;
    const long long b = bs / sq, s = bs - b * sq;
    delta[(b * heads + h) * sq + s] = sum;
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block a (batch, kv head, BK-key tile)
// ---------------------------------------------------------------------------
// Shared memory (floats): K [DQK][BK + 4] and V [DV][BK + 4] transposed;
// Q and dO transposed ([DQK], [DV] x [BQ + 4]) and row-major ([BQ] x
// [DQK + 4], [DV + 4]); P and dS [BQ][BK + 4]; lse (base 2) and D for BQ
// rows.  The 4 floats of padding a row keep 16-byte vectors aligned and
// spread a warp's stores over the banks.
template <int DQK, int DV, int BK, int BQ>
__host__ __device__ constexpr int dkdv_smem_floats() {
  return (DQK + DV) * (BK + 4) + (DQK + DV) * (BQ + 4) + BQ * (DQK + 4) +
         BQ * (DV + 4) + 2 * BQ * (BK + 4) + 2 * BQ;
}

template <int DQK, int DV, int BK, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int sq, int skv,
            int heads, int kv_heads, int causal, int window, float scale) {
  constexpr int RK = BK / 16;            // keys of a thread
  constexpr int RQ = BQ / 16;            // queries of a thread (scores)
  constexpr int LK = BK + 4, LQ = BQ + 4;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                      // [DQK][LK]
  float* vt = kt + DQK * LK;             // [DV][LK]
  float* qt = vt + DV * LK;              // [DQK][LQ]
  float* dot = qt + DQK * LQ;            // [DV][LQ]
  float* qr = dot + DV * LQ;             // [BQ][DQK + 4]
  float* dor = qr + BQ * (DQK + 4);      // [BQ][DV + 4]
  float* ps = dor + BQ * (DV + 4);       // [BQ][LK]
  float* dss = ps + BQ * LK;             // [BQ][LK]
  float* lse_s = dss + BQ * LK;          // [BQ], base 2
  float* dl_s = lse_s + BQ;              // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int k1 = min(k0 + BK, skv);
  const float scale_log2 = scale * kLog2e;

  const float* kb = k + (long long)b * skv * kv_heads * DQK;
  const float* vb = v + (long long)b * skv * kv_heads * DV;
  stage<DQK, BK>(kb, skv, kv_heads, kvh, k0, kt, LK, nullptr);
  stage<DV, BK>(vb, skv, kv_heads, kvh, k0, vt, LK, nullptr);

  float acc_k[RK][DQK / 16], acc_v[RK][DV / 16];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
#pragma unroll
    for (int c = 0; c < DQK / 16; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DV / 16; ++c) acc_v[i][c] = 0.f;
  }

  // the query rows that may see a key of [k0, k1)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k1 - 1 + window) : sq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* qb = q + (long long)b * sq * heads * DQK;
    const float* db = dout + (long long)b * sq * heads * DV;
    const float* lb = lse + ((long long)b * heads + h) * sq;
    const float* deb = delta + ((long long)b * heads + h) * sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile's q, dO, P and dS are consumed
      stage<DQK, BQ>(qb, sq, heads, h, q0, qt, LQ, qr);
      stage<DV, BQ>(db, sq, heads, h, q0, dot, LQ, dor);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const int row = q0 + r;
        lse_s[r] = row < sq ? lb[row] * kLog2e : 0.f;
        dl_s[r] = row < sq ? deb[row] : 0.f;
      }
      __syncthreads();

      float s[RK][RQ], dp[RK][RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) s[i][j] = dp[i][j] = 0.f;
      tile_product<RK, RQ, DQK>(s, kt + ty * RK, LK, qt + tx * RQ, LQ);
      tile_product<RK, RQ, DV>(dp, vt + ty * RK, LK, dot + tx * RQ, LQ);
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int kpos = k0 + ty * RK + i;
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          const int r = tx * RQ + j;
          const int qpos = q0 + r;
          const float p =
              visible(qpos, kpos, sq, skv, causal, window)
                  ? exp2f(s[i][j] * scale_log2 - lse_s[r]) : 0.f;
          ps[r * LK + ty * RK + i] = p;
          dss[r * LK + ty * RK + i] = p * (dp[i][j] - dl_s[r]);
        }
      }
      __syncthreads();
      // a query tile's share summed apart and then added: the sum over a
      // group's heads and every query of the band (up to 32,768 terms at
      // RecurrentGemma's shape) in two levels, not one long chain
      float part_k[RK][DQK / 16], part_v[RK][DV / 16];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int c = 0; c < DQK / 16; ++c) part_k[i][c] = 0.f;
#pragma unroll
        for (int c = 0; c < DV / 16; ++c) part_v[i][c] = 0.f;
      }
      accumulate<RK, DV, BQ>(part_v, ps + ty * RK, LK, dor + tx * 4);
      accumulate<RK, DQK, BQ>(part_k, dss + ty * RK, LK, qr + tx * 4);
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int c = 0; c < DQK / 16; ++c) acc_k[i][c] += part_k[i][c];
#pragma unroll
        for (int c = 0; c < DV / 16; ++c) acc_v[i][c] += part_v[i][c];
      }
    }
  }

  float* dkb = dk + (long long)b * skv * kv_heads * DQK;
  float* dvb = dv + (long long)b * skv * kv_heads * DV;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty * RK + i;
    if (key >= skv) continue;
    const long long row = (long long)key * kv_heads + kvh;
#pragma unroll
    for (int g = 0; g < DQK / 64; ++g)
      store4(dkb + row * DQK + g * 64 + tx * 4,
             make_float4(acc_k[i][g * 4] * scale, acc_k[i][g * 4 + 1] * scale,
                         acc_k[i][g * 4 + 2] * scale,
                         acc_k[i][g * 4 + 3] * scale));
#pragma unroll
    for (int g = 0; g < DV / 64; ++g)
      store4(dvb + row * DV + g * 64 + tx * 4,
             make_float4(acc_v[i][g * 4], acc_v[i][g * 4 + 1],
                         acc_v[i][g * 4 + 2], acc_v[i][g * 4 + 3]));
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block a (batch, head, BQ-query tile)
// ---------------------------------------------------------------------------
// Shared memory (floats): Q [DQK] and dO [DV] x [BQ + 4] transposed; K
// [DQK] and V [DV] x [BK + 4] transposed; K row-major [BK][DQK + 4]; dS
// transposed [BK][BQ + 4]; lse (base 2) and D for BQ rows.
template <int DQK, int DV, int BQ, int BK>
__host__ __device__ constexpr int dq_smem_floats() {
  return (DQK + DV) * (BQ + 4) + (DQK + DV) * (BK + 4) + BK * (DQK + 4) +
         BK * (BQ + 4) + 2 * BQ;
}

template <int DQK, int DV, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int sq, int skv, int heads, int kv_heads,
          int causal, int window, float scale) {
  constexpr int RQ = BQ / 16;            // queries of a thread
  constexpr int RK = BK / 16;            // keys of a thread (scores)
  constexpr int LK = BK + 4, LQ = BQ + 4;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [DQK][LQ]
  float* dot = qt + DQK * LQ;            // [DV][LQ]
  float* kt = dot + DV * LQ;             // [DQK][LK]
  float* vt = kt + DQK * LK;             // [DV][LK]
  float* kr = vt + DV * LK;              // [BK][DQK + 4]
  float* dst = kr + BK * (DQK + 4);      // [BK][LQ]
  float* lse_s = dst + BK * LQ;          // [BQ], base 2
  float* dl_s = lse_s + BQ;              // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest bands first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = (int)((long long)h * kv_heads / heads);
  const int q1 = min(q0 + BQ, sq);
  const float scale_log2 = scale * kLog2e;

  stage<DQK, BQ>(q + (long long)b * sq * heads * DQK, sq, heads, h, q0, qt,
                 LQ, nullptr);
  stage<DV, BQ>(dout + (long long)b * sq * heads * DV, sq, heads, h, q0,
                dot, LQ, nullptr);
  const float* lb = lse + ((long long)b * heads + h) * sq;
  const float* deb = delta + ((long long)b * heads + h) * sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = q0 + r;
    lse_s[r] = row < sq ? lb[row] * kLog2e : 0.f;
    dl_s[r] = row < sq ? deb[row] : 0.f;
  }

  float acc[RQ][DQK / 16];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DQK / 16; ++c) acc[i][c] = 0.f;

  const float* kb = k + (long long)b * skv * kv_heads * DQK;
  const float* vb = v + (long long)b * skv * kv_heads * DV;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(q1, skv) : skv;
  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();   // the previous tile's K, V and dS are consumed
    stage<DQK, BK>(kb, skv, kv_heads, kvh, j0, kt, LK, kr);
    stage<DV, BK>(vb, skv, kv_heads, kvh, j0, vt, LK, nullptr);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<RQ, RK, DQK>(s, qt + ty * RQ, LQ, kt + tx * RK, LK);
    tile_product<RQ, RK, DV>(dp, dot + ty * RQ, LQ, vt + tx * RK, LK);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx * RK + j;
        const float p =
            visible(qpos, j0 + c, sq, skv, causal, window)
                ? exp2f(s[i][j] * scale_log2 - lse_s[r]) : 0.f;
        dst[c * LQ + r] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();
    accumulate<RQ, DQK, BK>(acc, dst + ty * RQ, LQ, kr + tx * 4);
  }

  float* dqb = dq + (long long)b * sq * heads * DQK;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= sq) continue;
    const long long off = ((long long)row * heads + h) * DQK;
#pragma unroll
    for (int g = 0; g < DQK / 64; ++g)
      store4(dqb + off + g * 64 + tx * 4,
             make_float4(acc[i][g * 4] * scale, acc[i][g * 4 + 1] * scale,
                         acc[i][g * 4 + 2] * scale,
                         acc[i][g * 4 + 3] * scale));
  }
}


// ---------------------------------------------------------------------------
// bfloat16: warp-specialised blocks, TMA-fed rings, wgmma
// ---------------------------------------------------------------------------
// Both passes are blocks of three warpgroups, as the forward's: one producer
// warp issues TMA loads of swizzled 64-row tiles (hopper.cuh) into a ring
// of stages guarded by full and empty mbarriers; two consumer warpgroups
// run wgmma on what has arrived.  setmaxnreg gives the producer 24
// registers and each consumer 240.  Every product reads its operands where
// the TMA put them: a score product sums over hd, both tiles K-major; an
// accumulation sums over the 64 rows of a tile, its A operand (P, dS or
// their transposes) from registers and its B tile MN-major through the
// descriptor's transpose bit.  The scores are computed once per (key tile,
// query tile) for the whole head dim.
//
// Rows pass (bwd_rows_kernel): one block a (64-row query tile, head,
// batch), 8 lanes a row reading O and dO as 16-byte vectors; it writes
// the tile's lse (in base 2) and D side by side into the scratch, 512
// contiguous bytes a tile, zeros past Sq, so each stage of a pass below
// takes them in one bulk copy.
//
// dK/dV pass: K and V of the block's keys stay resident; the producer
// streams the Q and dO tiles (and their rows) of each query head of the
// block's split and each query tile of the band.  Two shapes, by q's head
// dim DQK:
//   * hd 64 (dkdv_pair_kernel, below): 128 keys, 64 a consumer, each
//     consumer running the whole chain for its keys: S^T = K Q^T and
//     dP^T = V dO^T, P^T = exp2(S^T scale log2e - lse2) and dS^T =
//     P^T (dP^T - D) in registers, then dV += P^T dO and dK += dS^T Q;
//     both accumulators (32 registers each) fit, and each Q/dO tile feeds
//     128 keys;
//   * DQK 128, 192 and 256 (dkdv_ws_kernel): 64 keys, the consumers
//     splitting the work by role.  Consumer 0: S^T (over DQK), P^T in
//     registers, written to shared memory in fragment order (float32, a
//     named barrier), then dV += P^T dO (DV columns); consumer 1: dP^T
//     (over DV), dS^T with P^T read back, then dK += dS^T Q (DQK
//     columns).  Each holds one float32 accumulator of 64 rows: 128
//     registers a thread at hd 256, where both would not fit one
//     warpgroup; at (192, 128) both declare the wider, 96 registers, and
//     consumer 0 uses its first 64.
//
// MQA: where batch x kv heads x key blocks gives too few blocks for the
// SMs (RecurrentGemma: one kv head, B 1: 64 blocks), a group's query heads
// are split over up to 4 blocks (head_splits); each writes its float32
// partial dK and dV to the scratch, and dkdv_reduce_kernel sums them in
// split order.
//
// dQ pass (dq_ws_kernel): the forward's block.  Two consumers share each K
// and V tile: two query heads of one kv head over the same 64 rows when
// H / K is even, else two consecutive 64-row tiles of one head.  Per tile:
// S = Q K^T and dP = dO V^T, dS = P (dP - D), dQ += dS K.  One K/V stage
// at hd 256, where both consumers' Q and dO take 128 KB; three at (192,
// 128), where four would take 247,936 bytes.
//
// Each ring has the most stages, up to four, with which its pass fits the
// card's 232,448 bytes (ring_stages).
//
// Each consumer runs a tile's chain in series: its score products, the
// elementwise work, its accumulation products.  At hd 64 the elementwise
// work weighs as much as the products, so P takes one multiply-add and
// the ex2 unit (exp2_fma), a tile wholly inside the band takes no
// per-element mask (tile_kind, a separate loop), and the bfloat16 parts
// are cut with a byte permute (a_frags).  P and dS are fed to the
// products as two bfloat16 parts, two products each: one rounding of P
// moved dV, and one of dS moved dK, outside the bf16 kernel limit.  So
// the tensor work issued is 20 hd a visible pair: S and dP twice, dV, dK
// and dQ twice.
//
// Knock-outs for timing only (bwd_passes.py builds them with -D): each
// drops one kind of work from the bf16 passes, and the gradients are
// wrong.  LOTARU_BWD_NO_EXP: P without the ex2; LOTARU_BWD_NO_SCORE: no
// score products; LOTARU_BWD_NO_ACC: no accumulation products (their A
// fragments are still made).
#ifdef LOTARU_BWD_NO_EXP
constexpr bool kExp = false;
#else
constexpr bool kExp = true;
#endif
#ifdef LOTARU_BWD_NO_SCORE
constexpr bool kScores = false;
#else
constexpr bool kScores = true;
#endif
#ifdef LOTARU_BWD_NO_ACC
constexpr bool kAccs = false;
#else
constexpr bool kAccs = true;
#endif

constexpr int kWsThreads = 384;            // a producer and two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;         // 24 * 128 + 240 * 256 = 64,512
constexpr int kRowFloats = 2 * kBlockQ;    // a query tile's lse2 and D
constexpr int kRowBytes = kRowFloats * 4;
constexpr int kXBytes = kBlockK * kBlockQ * 4;   // the P^T exchange
constexpr int kRowsThreads = 8 * kBlockQ;  // the rows pass: 8 lanes a row
constexpr int kMaxSplits = 4;
constexpr int kBarPFull = 1;               // named barriers of the dK/dV
constexpr int kBarPEmpty = 2;              // consumers (0 is __syncthreads)
constexpr int kSmemOptin = 232448;         // an H100 block's opt-in bytes

// Keys of a dK/dV block: 128 at DQK 64 (dkdv_pair_kernel, 64 a consumer),
// 64 wider (dkdv_ws_kernel, both consumers on the same keys)
__host__ __device__ constexpr int dkdv_keys(int dqk) {
  return dqk == 64 ? 2 * kBlockK : kBlockK;
}

// Dynamic shared memory at `stages` (kernels/flash_attention.
// bwd_smem_bytes), each tile 64 rows: dK/dV K (DQK columns) and V (DV) of
// the block's keys, a ring of Q, dO and their rows, and above DQK 64 the
// P^T exchange; dQ both consumers' Q, dO and rows, a ring of K and V.
// 1024 bytes of slack start the tiles on the swizzle's 1024-byte period;
// 128 hold the mbarriers.
__host__ __device__ constexpr int dkdv_smem_at(int dqk, int dv, int stages) {
  return (dkdv_keys(dqk) / kBlockK + stages) * kBlockK * (dqk + dv) * 2 +
         stages * kRowBytes + (dqk == 64 ? 0 : kXBytes) + 1024 + 128;
}

__host__ __device__ constexpr int dq_smem_at(int dqk, int dv, int stages) {
  return (2 + stages) * kBlockK * (dqk + dv) * 2 + 2 * kRowBytes + 1024 +
         128;
}

// Stages of a pass's ring (which 0 the dK/dV pass's Q/dO ring, 1 the dQ
// pass's K/V ring): the most, up to four, with which the pass fits
// kSmemOptin.  dK/dV two at hd 256, four below and at (192, 128); dQ one at
// hd 256, three at (192, 128), four below (kernels/flash_attention.
// bwd_stages).
__host__ __device__ constexpr int ring_stages(int dqk, int dv, int which) {
  int st = 4;
  while (st > 1 && (which == 0 ? dkdv_smem_at(dqk, dv, st)
                               : dq_smem_at(dqk, dv, st)) > kSmemOptin)
    --st;
  return st;
}

__host__ __device__ constexpr int dkdv_stages(int dqk, int dv) {
  return ring_stages(dqk, dv, 0);
}

__host__ __device__ constexpr int dq_stages(int dqk, int dv) {
  return ring_stages(dqk, dv, 1);
}

__host__ __device__ constexpr int dkdv_smem_bytes(int dqk, int dv) {
  return dkdv_smem_at(dqk, dv, dkdv_stages(dqk, dv));
}

__host__ __device__ constexpr int dq_smem_bytes(int dqk, int dv) {
  return dq_smem_at(dqk, dv, dq_stages(dqk, dv));
}

// Blocks a kv head's query heads are split over in the dK/dV pass: of 1 to
// min(4, group), the one that minimises waves x heads a block, the fewest
// on a tie (kernels/flash_attention.bwd_head_splits).
__host__ __device__ inline int head_splits(int batch, int skv, int heads,
                                           int kv_heads, int sms, int dqk) {
  const long long n = (long long)batch * kv_heads *
                      ((skv + dkdv_keys(dqk) - 1) / dkdv_keys(dqk));
  const int group = heads / kv_heads;
  if (n == 0 || sms <= 0) return 1;
  int best = 1;
  long long best_cost = (n + sms - 1) / sms * group;
  for (int s = 2; s <= kMaxSplits && s <= group; ++s) {
    const long long cost = (n * s + sms - 1) / sms * ((group + s - 1) / s);
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// Float32 elements of the scratch: the rows (B, H, query tiles, 128) and,
// with head splits, the partial dV (splits, B, Skv, K, DV), then dK
// (splits, B, Skv, K, DQK); the float32 route's D (B, H, Sq)
// (kernels/flash_attention.bwd_scratch_floats).
inline long long scratch_floats(int dtype, int batch, int sq, int skv,
                                int heads, int kv_heads, int dqk, int dv,
                                int sms) {
  if (dtype != 1) return (long long)batch * heads * sq;
  const long long rows = (long long)batch * heads *
                         ((sq + kBlockQ - 1) / kBlockQ) * kRowFloats;
  const int splits = head_splits(batch, skv, heads, kv_heads, sms, dqk);
  return rows + (splits > 1 ? (long long)splits * batch * skv * kv_heads *
                                  (dqk + dv)
                            : 0);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// the consumer's stage is read: each warp's reads of it come before the
// producer's next TMA writes there
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// x, a 64 x 64 accumulator fragment, as the A fragments of four k-steps
// of 16 columns in two bfloat16 parts: x truncated to bfloat16 (hi: a
// byte permute, where rounding takes the conversion unit) and the
// bfloat16 rounding of the exact remainder (lo), 16 bits of x's mantissa
__device__ __forceinline__ void a_frags(const float (&x)[32],
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = x[8 * kk + 2 * e], c = x[8 * kk + 2 * e + 1];
      const uint32_t ab = __float_as_uint(a), cb = __float_as_uint(c);
      hi[kk][e] = __byte_perm(ab, cb, 0x7632);
      lo[kk][e] = pack_bf16(a - __uint_as_float(ab & 0xffff0000u),
                            c - __uint_as_float(cb & 0xffff0000u));
    }
}

// the LOTARU_BWD_NO_ACC knock-out: the fragments folded into o[0], so
// that they are still made
template <int N>
__device__ __forceinline__ void fold_frags(float (&o)[N],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4]) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x ^= hi[i][j] ^ lo[i][j];
  o[0] += __uint_as_float(x & 0x3fffffffu);
}

// o += A B over the tile's 64 rows, A in two bfloat16 parts from
// registers, B (64 rows x N) MN-major at bt; o's first N / 2 floats
template <int N, int M>
__device__ __forceinline__ void pv_parts(float (&o)[M],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t bt) {
  if constexpr (!kAccs) {
    fold_frags(o, hi, lo);
    return;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    const uint64_t desc = smem_desc(bt + kk * 16 * 128, kBoxBytes, 1024);
    wgmma_pv<N>(o, hi[kk], desc);
    wgmma_pv<N>(o, lo[kk], desc);
  }
  wgmma_commit_wait();
  fence_regs(o);
}

// 2^(a b - c) from one multiply-add and the special-function unit's ex2
// (2 ulp, results below 2^-126 flushed to 0), as fast-math exp2f takes it;
// the accurate exp2f cost the hd 64 passes a third of their time
__device__ __forceinline__ float exp2_fma(float a, float b, float c) {
  if constexpr (!kExp) return __fmaf_rn(a, b, -c);
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmaf_rn(a, b, -c)));
  return y;
}

// s = A B^T over DS columns and dp = A' B'^T over DP, all four tiles
// K-major: one commit
template <int DS, int DP>
__device__ __forceinline__ void score_pair(float (&s)[32], float (&dp)[32],
                                           uint32_t at, uint32_t bt,
                                           uint32_t at2, uint32_t bt2) {
  if constexpr (!kScores) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    return;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DS / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss_n64(s, smem_desc(at + off, 16, 1024),
                 smem_desc(bt + off, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss_n64(dp, smem_desc(at2 + off, 16, 1024),
                 smem_desc(bt2 + off, 16, 1024), kk > 0);
  }
  wgmma_commit_wait();
  fence_regs(s);
  fence_regs(dp);
}

// the rows pass: D over o's DV columns
template <int D>
__global__ void __launch_bounds__(kRowsThreads)
bwd_rows_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ rows,
                int sq, int heads) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int r = threadIdx.x >> 3, j = threadIdx.x & 7;
  const int row = qt * kBlockQ + r;
  float sum = 0.f;
  if (row < sq) {
    const long long off = (((long long)b * sq + row) * heads + h) * D + j * 8;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + off + c * 64);
      const uint4 d = *reinterpret_cast<const uint4*>(dout + off + c * 64);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(d2[e]);
        sum += x.x * y.x;
        sum += x.y * y.y;
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  float* out =
      rows + (((long long)b * heads + h) * gridDim.x + qt) * kRowFloats;
  if (j == 0) out[kBlockQ + r] = sum;
  if (threadIdx.x < kBlockQ) {
    const int rr = qt * kBlockQ + threadIdx.x;
    out[threadIdx.x] =
        rr < sq ? lse[((long long)b * heads + h) * sq + rr] * kLog2e : 0.f;
  }
}

// row r (0: the fragment's first row, 1: eight below) of an accumulator
// fragment N columns wide, times mul, as bfloat16 pairs from dst (the row's
// start plus 2 t)
template <int N, int M>
__device__ __forceinline__ void store_row_bf16(__nv_bfloat16* dst,
                                               const float (&acc)[M], int r,
                                               float mul) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
    *reinterpret_cast<uint32_t*>(dst + 8 * n) =
        pack_bf16(acc[4 * n + 2 * r] * mul, acc[4 * n + 2 * r + 1] * mul);
}

// the same row in float32, unscaled (a head split's partial)
template <int N, int M>
__device__ __forceinline__ void store_row_f32(float* dst,
                                              const float (&acc)[M], int r) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
    *reinterpret_cast<float2*>(dst + 8 * n) =
        make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kWsThreads, 1)
dkdv_ws_kernel(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap domap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const float* __restrict__ rows,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               float* __restrict__ part, int sq, int skv, int heads,
               int kv_heads, int causal, int window, float scale,
               int splits) {
  constexpr int kStages = dkdv_stages(DQK, DV);
  constexpr int kTile = kBlockK * DQK * 2;     // bytes of a 64-row K/Q tile
  constexpr int kTileV = kBlockK * DV * 2;     // and of a V/dO tile
  constexpr int kAcc = (DQK > DV ? DQK : DV) / 2;   // the wider role's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;                  // K
  const uint32_t v_s = k_s + kTile;                            // V
  const uint32_t q_s = v_s + kTileV;                           // Q ring
  const uint32_t do_s = q_s + kStages * kTile;                 // dO ring
  const uint32_t r_s = do_s + kStages * kTileV;                // rows ring
  const uint32_t x_s = r_s + kStages * kRowBytes;              // P^T
  const uint32_t bar_kv = x_s + kXBytes;
  const uint32_t bar_full = bar_kv + 8;                        // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;           // [kStages]
  const float* rows_s = reinterpret_cast<const float*>(smem_raw + (r_s - raw));
  float* xp = reinterpret_cast<float*>(smem_raw + (x_s - raw));

  const int wg = threadIdx.x >> 7;
  const int k0 = blockIdx.x * kBlockK;
  const int kvh = blockIdx.y / splits;
  const int sp = blockIdx.y % splits;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int h_lo = kvh * group + sp * group / splits;
  const int h_hi = kvh * group + (sp + 1) * group / splits;
  const int k1 = min(k0 + kBlockK, skv);
  // the query tiles that may see a key of [k0, k1)
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(sq, k1 - 1 + window) : sq;
  const int n_qt = q_end > q_first ? (q_end - q_first + kBlockQ - 1) / kBlockQ
                                   : 0;
  const int n_it = (h_hi - h_lo) * n_qt;
  const int nqt_all = (sq + kBlockQ - 1) / kBlockQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);           // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, kTile + kTileV);
      tma_tile<DQK>(k_s, &kmap, bar_kv, kvh, k0, b);
      tma_tile<DV>(v_s, &vmap, bar_kv, kvh, k0, b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int h = h_lo + it / n_qt;
        const int q0 = q_first + (it % n_qt) * kBlockQ;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, kTile + kTileV + kRowBytes);
        tma_tile<DQK>(q_s + s * kTile, &qmap, bar_full + 8 * s, h, q0, b);
        tma_tile<DV>(do_s + s * kTileV, &domap, bar_full + 8 * s, h, q0,
                     b);
        bulk_copy(r_s + s * kRowBytes,
                  rows + (((long long)b * heads + h) * nqt_all +
                          q0 / kBlockQ) * kRowFloats,
                  kRowBytes, bar_full + 8 * s);
      }
    }
    return;
  }

  // ---- a consumer: 0 takes P^T and dV, 1 dS^T and dK ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = k0 + warp * 16 + g;           // keys key0 and key0 + 8
  const float scale_log2 = scale * kLog2e;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  int shared_tiles = 0;                          // P^T exchanges made

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = q_first + (it % n_qt) * kBlockQ;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    const int kind = tile_kind(q0, min(q0 + kBlockQ, sq), k0, skv, causal,
                               window);
    if (kind != kSkip) {
      const float* lse2 = rows_s + s * kRowFloats;
      const float* dl = lse2 + kBlockQ;
      // x[i]: key row key0 + 8 ((i >> 1) & 1), query column
      // 8 (i >> 2) + 2 t + (i & 1) of the tile
      float x[32];
      uint32_t hi[4][4], lo[4][4];
      if (c == 0) {
        if constexpr (kScores)
          qk_product<DQK>(x, k_s, q_s + s * kTile);      // S^T
        else for (int i = 0; i < 32; ++i) x[i] = 0.f;
        auto p_loop = [&](auto full) {
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int ql = 8 * (i >> 2) + 2 * t;
            const int key = key0 + 8 * ((i >> 1) & 1);
            const float2 l2 = *reinterpret_cast<const float2*>(lse2 + ql);
            const bool v0 = decltype(full)::value ||
                (q0 + ql < sq && visible(q0 + ql, key, skv, causal, window));
            const bool v1 = decltype(full)::value ||
                (q0 + ql + 1 < sq &&
                 visible(q0 + ql + 1, key, skv, causal, window));
            x[i] = v0 ? exp2_fma(x[i], scale_log2, l2.x) : 0.f;
            x[i + 1] = v1 ? exp2_fma(x[i + 1], scale_log2, l2.y) : 0.f;
          }
        };
        if (kind == kFull) p_loop(std::true_type{});   // no mask
        else p_loop(std::false_type{});
        if (shared_tiles > 0) named_sync(kBarPEmpty);   // the last P^T read
#pragma unroll
        for (int j = 0; j < 8; ++j)
          reinterpret_cast<float4*>(xp)[j * 128 + tid] =
              make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
        named_arrive(kBarPFull);
        a_frags(x, hi, lo);
        pv_parts<DV>(acc, hi, lo, do_s + s * kTileV);  // dV
      } else {
        if constexpr (kScores)
          qk_product<DV>(x, v_s, do_s + s * kTileV);     // dP^T
        else for (int i = 0; i < 32; ++i) x[i] = 0.f;
        named_sync(kBarPFull);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 p = reinterpret_cast<const float4*>(xp)[j * 128 + tid];
          // elements 4 j + e are query columns 8 j + 2 t + (e & 1)
          const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
          x[4 * j] = p.x * (x[4 * j] - d2.x);
          x[4 * j + 1] = p.y * (x[4 * j + 1] - d2.y);
          x[4 * j + 2] = p.z * (x[4 * j + 2] - d2.x);
          x[4 * j + 3] = p.w * (x[4 * j + 3] - d2.y);
        }
        named_arrive(kBarPEmpty);
        a_frags(x, hi, lo);
        pv_parts<DQK>(acc, hi, lo, q_s + s * kTile);   // dK
      }
      ++shared_tiles;
    }
    release(bar_empty + 8 * s, lane);
  }
  if (c == 0 && shared_tiles > 0) named_sync(kBarPEmpty);

  // dV (consumer 0, DV columns) or dK (1, DQK columns) of keys key0 and
  // key0 + 8; a head split's partials: dV's planes, then dK's
  const float mul = c == 1 ? scale : 1.f;
  const long long plane_v = (long long)gridDim.z * skv * kv_heads * DV;
  const long long plane_k = (long long)gridDim.z * skv * kv_heads * DQK;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    const long long row = ((long long)b * skv + key) * kv_heads + kvh;
    if (splits == 1) {
      if (c == 1) store_row_bf16<DQK>(dk + row * DQK + 2 * t, acc, r, mul);
      else store_row_bf16<DV>(dv + row * DV + 2 * t, acc, r, mul);
    } else if (c == 1) {
      store_row_f32<DQK>(part + splits * plane_v + sp * plane_k + row * DQK +
                             2 * t, acc, r);
    } else {
      store_row_f32<DV>(part + sp * plane_v + row * DV + 2 * t, acc, r);
    }
  }
}

// dK/dV at hd 64 (dkdv_pair_kernel): a block takes 128 keys, 64 a
// consumer, and each consumer runs the whole chain for its keys: S^T and
// dP^T (one commit), P^T and dS^T in registers, then dV and dK (one commit,
// two independent accumulator chains).  Both accumulators (32 registers
// each) fit beside the scores, so nothing is exchanged; each Q/dO tile
// the producer loads feeds 128 keys.
template <int D>
__device__ __forceinline__ void pv_pair(float (&o1)[D / 2],
                                        const uint32_t (&h1)[4][4],
                                        const uint32_t (&l1)[4][4],
                                        uint32_t b1, float (&o2)[D / 2],
                                        const uint32_t (&h2)[4][4],
                                        const uint32_t (&l2)[4][4],
                                        uint32_t b2) {
  if constexpr (!kAccs) {
    fold_frags(o1, h1, l1);
    fold_frags(o2, h2, l2);
    return;
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    const uint64_t d1 = smem_desc(b1 + kk * 16 * 128, kBoxBytes, 1024);
    const uint64_t d2 = smem_desc(b2 + kk * 16 * 128, kBoxBytes, 1024);
    wgmma_pv<D>(o1, h1[kk], d1);
    wgmma_pv<D>(o2, h2[kk], d2);
    wgmma_pv<D>(o1, l1[kk], d1);
    wgmma_pv<D>(o2, l2[kk], d2);
  }
  wgmma_commit_wait();
  fence_regs(o1);
  fence_regs(o2);
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
dkdv_pair_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap domap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const float* __restrict__ rows,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                 int sq, int skv, int heads, int kv_heads, int causal,
                 int window, float scale, int splits) {
  constexpr int kStages = dkdv_stages(D, D);
  constexpr int kTile = kBlockK * D * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;                  // K of 0, 1
  const uint32_t v_s = k_s + 2 * kTile;                        // V of 0, 1
  const uint32_t q_s = v_s + 2 * kTile;                        // Q ring
  const uint32_t do_s = q_s + kStages * kTile;                 // dO ring
  const uint32_t r_s = do_s + kStages * kTile;                 // rows ring
  const uint32_t bar_kv = r_s + kStages * kRowBytes;
  const uint32_t bar_full = bar_kv + 8;                        // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;           // [kStages]
  const float* rows_s = reinterpret_cast<const float*>(smem_raw + (r_s - raw));

  const int wg = threadIdx.x >> 7;
  const int k0 = blockIdx.x * 2 * kBlockK;
  const int kvh = blockIdx.y / splits;
  const int sp = blockIdx.y % splits;
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int h_lo = kvh * group + sp * group / splits;
  const int h_hi = kvh * group + (sp + 1) * group / splits;
  const int k1 = min(k0 + 2 * kBlockK, skv);
  const int n_k = k0 + kBlockK < skv ? 2 : 1;    // key tiles with keys
  // the query tiles that may see a key of [k0, k1)
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(sq, k1 - 1 + window) : sq;
  const int n_qt = q_end > q_first ? (q_end - q_first + kBlockQ - 1) / kBlockQ
                                   : 0;
  const int n_it = (h_hi - h_lo) * n_qt;
  const int nqt_all = (sq + kBlockQ - 1) / kBlockQ;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, 2 * n_k * kTile);
      for (int c = 0; c < n_k; ++c) {
        tma_tile<D>(k_s + c * kTile, &kmap, bar_kv, kvh, k0 + c * kBlockK, b);
        tma_tile<D>(v_s + c * kTile, &vmap, bar_kv, kvh, k0 + c * kBlockK, b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int h = h_lo + it / n_qt;
        const int q0 = q_first + (it % n_qt) * kBlockQ;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kTile + kRowBytes);
        tma_tile<D>(q_s + s * kTile, &qmap, bar_full + 8 * s, h, q0, b);
        tma_tile<D>(do_s + s * kTile, &domap, bar_full + 8 * s, h, q0, b);
        bulk_copy(r_s + s * kRowBytes,
                  rows + (((long long)b * heads + h) * nqt_all +
                          q0 / kBlockQ) * kRowFloats,
                  kRowBytes, bar_full + 8 * s);
      }
    }
    return;
  }

  // ---- a consumer: keys kc + [0, 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kc = k0 + c * kBlockK;
  const int key0 = kc + warp * 16 + g;           // keys key0 and key0 + 8
  const float scale_log2 = scale * kLog2e;

  float acc_v[D / 2], acc_k[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_v[i] = acc_k[i] = 0.f;

  if (c < n_k) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = q_first + (it % n_qt) * kBlockQ;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    const int kind = tile_kind(q0, min(q0 + kBlockQ, sq), kc, skv, causal,
                               window);
    if (kind != kSkip) {
      const float* lse2 = rows_s + s * kRowFloats;
      const float* dl = lse2 + kBlockQ;
      // x[i], dp[i]: key row key0 + 8 ((i >> 1) & 1), query column
      // 8 (i >> 2) + 2 t + (i & 1) of the tile
      float x[32], dp[32];
      score_pair<D, D>(x, dp, k_s + c * kTile, q_s + s * kTile,
                       v_s + c * kTile, do_s + s * kTile);  // S^T, dP^T
      auto ds_loop = [&](auto full) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int ql = 8 * (i >> 2) + 2 * t;
          const int key = key0 + 8 * ((i >> 1) & 1);
          const float2 l2 = *reinterpret_cast<const float2*>(lse2 + ql);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + ql);
          const bool v0 = decltype(full)::value ||
              (q0 + ql < sq && visible(q0 + ql, key, skv, causal, window));
          const bool v1 = decltype(full)::value ||
              (q0 + ql + 1 < sq &&
               visible(q0 + ql + 1, key, skv, causal, window));
          x[i] = v0 ? exp2_fma(x[i], scale_log2, l2.x) : 0.f;
          x[i + 1] = v1 ? exp2_fma(x[i + 1], scale_log2, l2.y) : 0.f;
          dp[i] = x[i] * (dp[i] - d2.x);
          dp[i + 1] = x[i + 1] * (dp[i + 1] - d2.y);
        }
      };
      if (kind == kFull) ds_loop(std::true_type{});     // no mask
      else ds_loop(std::false_type{});
      uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
      a_frags(x, ph, pl);
      a_frags(dp, sh, sl);
      pv_pair<D>(acc_v, ph, pl, do_s + s * kTile, acc_k, sh, sl,
                 q_s + s * kTile);                         // dV, dK
    }
    release(bar_empty + 8 * s, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    const long long row = ((long long)b * skv + key) * kv_heads + kvh;
    if (splits == 1) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dv + row * D + 8 * n + 2 * t) =
            pack_bf16(acc_v[4 * n + 2 * r], acc_v[4 * n + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dk + row * D + 8 * n + 2 * t) =
            pack_bf16(acc_k[4 * n + 2 * r] * scale,
                      acc_k[4 * n + 2 * r + 1] * scale);
      }
    } else {
      const long long plane = (long long)gridDim.z * skv * kv_heads * D;
      float* pv = part + (long long)sp * plane + row * D + 2 * t;
      float* pk = part + (long long)(splits + sp) * plane + row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(pv + 8 * n) =
            make_float2(acc_v[4 * n + 2 * r], acc_v[4 * n + 2 * r + 1]);
        *reinterpret_cast<float2*>(pk + 8 * n) =
            make_float2(acc_k[4 * n + 2 * r], acc_k[4 * n + 2 * r + 1]);
      }
    }
  }
}

// dV and dK from the head splits' float32 partials (dV's splits, planes of
// n_v elements, then dK's, planes of n_k), summed in split order; 4
// elements a thread
__global__ void __launch_bounds__(256)
dkdv_reduce_kernel(const float* __restrict__ part,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, long long n_v,
                   long long n_k, int splits, float scale) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const long long n = w == 1 ? n_k : n_v;
    if (i >= n) continue;
    const float* src = part + (w == 1 ? splits * n_v : 0);
    float4 s = *reinterpret_cast<const float4*>(src + i);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(src + sp * n + i);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const float mul = w == 1 ? scale : 1.f;
    *reinterpret_cast<uint2*>((w == 1 ? dk : dv) + i) =
        make_uint2(pack_bf16(s.x * mul, s.y * mul),
                   pack_bf16(s.z * mul, s.w * mul));
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kWsThreads, 1)
dq_ws_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap domap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const float* __restrict__ rows, __nv_bfloat16* __restrict__ dq,
             int sq, int skv, int heads, int kv_heads, int causal, int window,
             float scale, int pair_heads) {
  constexpr int kStages = dq_stages(DQK, DV);
  constexpr int kTile = kBlockK * DQK * 2;     // a Q/K tile
  constexpr int kTileV = kBlockK * DV * 2;     // a dO/V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;                  // Q of 0, 1
  const uint32_t do_s = q_s + 2 * kTile;                       // dO of 0, 1
  const uint32_t k_s = do_s + 2 * kTileV;                      // K ring
  const uint32_t v_s = k_s + kStages * kTile;                  // V ring
  const uint32_t r_s = v_s + kStages * kTileV;                 // rows of 0, 1
  const uint32_t bar_q = r_s + 2 * kRowBytes;
  const uint32_t bar_full = bar_q + 8;                         // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;           // [kStages]
  const float* rows_s = reinterpret_cast<const float*>(smem_raw + (r_s - raw));

  const int wg = threadIdx.x >> 7;
  const int b = blockIdx.z;
  const int tile = gridDim.x - 1 - blockIdx.x;   // the longest bands first
  const int head0 = pair_heads ? 2 * blockIdx.y : blockIdx.y;
  const int head_step = pair_heads ? 1 : 0;
  const int q_lo0 = (pair_heads ? tile : 2 * tile) * kBlockQ;
  const int q_step = pair_heads ? 0 : kBlockQ;
  const int kvh = (int)((long long)head0 * kv_heads / heads);
  const int nqt_all = (sq + kBlockQ - 1) / kBlockQ;
  // the block walks the union of its consumers' bands
  int lo = 0, hi = 0;
  band(q_lo0, min(q_lo0 + kBlockQ, sq), skv, causal, window, &lo, &hi);
  const int n_q = q_lo0 + q_step < sq ? 2 : 1;   // Q tiles with rows
  if (n_q == 2) {
    const int q_lo1 = q_lo0 + q_step;
    int lo1, hi1;
    band(q_lo1, min(q_lo1 + kBlockQ, sq), skv, causal, window, &lo1, &hi1);
    lo = min(lo, lo1);
    hi = max(hi, hi1);
  }
  const int n_tiles = hi > lo ? (hi - lo + kBlockK - 1) / kBlockK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- the producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, n_q * (kTile + kTileV + kRowBytes));
      for (int c = 0; c < n_q; ++c) {
        const int h = head0 + c * head_step;
        const int r0 = q_lo0 + c * q_step;
        tma_tile<DQK>(q_s + c * kTile, &qmap, bar_q, h, r0, b);
        tma_tile<DV>(do_s + c * kTileV, &domap, bar_q, h, r0, b);
        bulk_copy(r_s + c * kRowBytes,
                  rows + (((long long)b * heads + h) * nqt_all +
                          r0 / kBlockQ) * kRowFloats,
                  kRowBytes, bar_q);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, kTile + kTileV);
        const int j0 = lo + it * kBlockK;
        tma_tile<DQK>(k_s + s * kTile, &kmap, bar_full + 8 * s, kvh, j0, b);
        tma_tile<DV>(v_s + s * kTileV, &vmap, bar_full + 8 * s, kvh, j0, b);
      }
    }
    return;
  }

  // ---- a consumer ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs));
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int my_head = head0 + c * head_step;
  const int my_lo = q_lo0 + c * q_step;
  const int my_hi = min(my_lo + kBlockQ, sq);
  const int row0 = warp * 16 + g;                // rows row0 and row0 + 8
  const float scale_log2 = scale * kLog2e;

  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  const float* lse2 = rows_s + c * kRowFloats;
  const float l2[2] = {lse2[row0], lse2[row0 + 8]};
  const float d2[2] = {lse2[kBlockQ + row0], lse2[kBlockQ + row0 + 8]};

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = lo + it * kBlockK;
    const int s = it % kStages;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    const int kind = tile_kind(my_lo, my_hi, j0, skv, causal, window);
    if (kind != kSkip) {
      // x[i]: query row row0 + 8 ((i >> 1) & 1), key column
      // 8 (i >> 2) + 2 t + (i & 1) of the tile
      float x[32], dp[32];
      score_pair<DQK, DV>(x, dp, q_s + c * kTile, k_s + s * kTile,
                          do_s + c * kTileV, v_s + s * kTileV);  // S, dP
      auto ds_loop = [&](auto full) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int kpos = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
          const bool vis = decltype(full)::value ||
              visible(my_lo + row0 + 8 * r, kpos, skv, causal, window);
          const float p = vis ? exp2_fma(x[i], scale_log2, l2[r]) : 0.f;
          dp[i] = p * (dp[i] - d2[r]);
        }
      };
      if (kind == kFull) ds_loop(std::true_type{});     // no mask
      else ds_loop(std::false_type{});
      uint32_t hi_f[4][4], lo_f[4][4];
      a_frags(dp, hi_f, lo_f);
      pv_parts<DQK>(acc, hi_f, lo_f, k_s + s * kTile);  // dQ
    }
    release(bar_empty + 8 * s, lane);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = my_lo + row0 + 8 * r;
    if (row >= my_hi) continue;
    store_row_bf16<DQK>(
        dq + (((long long)b * sq + row) * heads + my_head) * DQK + 2 * t, acc,
        r, scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// Tiles of the float32 route by q's head dim: 64 keys and 64 queries at hd
// 64; 64 keys and 32 queries at hd 128; 32 and 32 at hd 256, where each
// staged tile of 32 rows is 32 KB of float32 (bwd_smem_bytes; the largest,
// dK/dV at hd 256, is 223,488 bytes of the 232,448 a block may opt in to),
// and at (192, 128), where a dK/dV thread's accumulators and partials hold
// 2 keys x (12 + 8) columns each.
template <int DQK> struct Tiles;
template <> struct Tiles<64> { static constexpr int BK = 64, BQ = 64; };
template <> struct Tiles<128> { static constexpr int BK = 64, BQ = 32; };
template <> struct Tiles<192> { static constexpr int BK = 32, BQ = 32; };
template <> struct Tiles<256> { static constexpr int BK = 32, BQ = 32; };

template <int DQK, int DV>
int smem_bytes(int which) {
  constexpr int BK = Tiles<DQK>::BK, BQ = Tiles<DQK>::BQ;
  return 4 * (which == 0 ? dkdv_smem_floats<DQK, DV, BK, BQ>()
                         : dq_smem_floats<DQK, DV, BQ, BK>());
}

template <int DQK, int DV>
int launch_f32(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* delta, float* dq, float* dk, float* dv, int batch,
               int sq, int skv, int heads, int kv_heads, int causal,
               int window, cudaStream_t stream) {
  constexpr int BK = Tiles<DQK>::BK, BQ = Tiles<DQK>::BQ;
  const float scale = 1.0f / sqrtf((float)DQK);
  const long long rows = (long long)batch * sq * heads;
  if (rows > 0) {
    delta_kernel<DV><<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
        o, dout, delta, batch, sq, heads);
  }
  if (skv > 0) {
    auto kern = dkdv_kernel<DQK, DV, BK, BQ>;
    const int bytes = smem_bytes<DQK, DV>(0);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((skv + BK - 1) / BK, kv_heads, batch);
    kern<<<grid, kThreads, bytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sq, skv, heads, kv_heads, causal,
        window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (sq > 0) {
    auto kern = dq_kernel<DQK, DV, BQ, BK>;
    const int bytes = smem_bytes<DQK, DV>(1);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + BQ - 1) / BQ, heads, batch);
    kern<<<grid, kThreads, bytes, stream>>>(
        q, k, v, dout, lse, delta, dq, sq, skv, heads, kv_heads, causal,
        window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// the bf16 dK/dV kernel of a pair (only it is instantiated)
template <int DQK, int DV>
auto dkdv_kernel_for() {
  if constexpr (DQK == 64) return dkdv_pair_kernel<DQK>;
  else return dkdv_ws_kernel<DQK, DV>;
}

// the card's SMs and opt-in shared memory a block
int card(int* sms, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* scratch, void* dq,
                void* dk, void* dv, int batch, int sq, int skv, int heads,
                int kv_heads, int causal, int window, cudaStream_t stream) {
  typedef __nv_bfloat16 bf16;
  int sms = 0, optin = 0;
  int rc = card(&sms, &optin);
  if (rc != 0) return rc;
  if (dkdv_smem_bytes(DQK, DV) > optin || dq_smem_bytes(DQK, DV) > optin)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sq == 0 && skv == 0) return 0;
  const float scale = 1.0f / sqrtf((float)DQK);
  const int nqt = (sq + kBlockQ - 1) / kBlockQ;
  if (sq > 0)
    bwd_rows_kernel<DV><<<dim3(nqt, heads, batch), kRowsThreads, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
        scratch, sq, heads);
  // with no queries (keys) no Q/dO (K/V) tile is loaded; the maps need a
  // base and a row all the same, so they map the other operand (DV <= DQK:
  // a map of DV columns stays inside it)
  CUtensorMap qm, dom, km, vm;
  const bool has_q = sq > 0, has_k = skv > 0;
  rc = bf16_map(&qm, has_q ? q : k, DQK, has_q ? heads : kv_heads,
                has_q ? sq : skv, batch);
  if (rc == 0) rc = bf16_map(&dom, has_q ? dout : k, DV,
                             has_q ? heads : kv_heads, has_q ? sq : skv,
                             batch);
  if (rc == 0) rc = bf16_map(&km, has_k ? k : q, DQK,
                             has_k ? kv_heads : heads, has_k ? skv : sq,
                             batch);
  if (rc == 0) rc = bf16_map(&vm, has_k ? v : q, DV,
                             has_k ? kv_heads : heads, has_k ? skv : sq,
                             batch);
  if (rc != 0) return rc;
  cudaError_t err;
  if (has_k) {
    const int splits = head_splits(batch, skv, heads, kv_heads, sms, DQK);
    float* part = scratch + (long long)batch * heads * nqt * kRowFloats;
    const int bytes = dkdv_smem_bytes(DQK, DV);
    auto kernel = dkdv_kernel_for<DQK, DV>();
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((skv + dkdv_keys(DQK) - 1) / dkdv_keys(DQK),
                    kv_heads * splits, batch);
    kernel<<<grid, kWsThreads, bytes, stream>>>(
        qm, dom, km, vm, scratch, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), part, sq, skv, heads, kv_heads, causal,
        window, scale, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (splits > 1) {
      const long long n_v = (long long)batch * skv * kv_heads * DV;
      const long long n_k = (long long)batch * skv * kv_heads * DQK;
      const long long n = n_k > n_v ? n_k : n_v;
      dkdv_reduce_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0,
                           stream>>>(part, static_cast<bf16*>(dk),
                                     static_cast<bf16*>(dv), n_v, n_k,
                                     splits, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (has_q) {
    const int bytes = dq_smem_bytes(DQK, DV);
    err = cudaFuncSetAttribute(dq_ws_kernel<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int pair_heads = (heads / kv_heads) % 2 == 0;
    const int rows_a_block = pair_heads ? kBlockQ : 2 * kBlockQ;
    const dim3 grid((sq + rows_a_block - 1) / rows_a_block,
                    pair_heads ? heads / 2 : heads, batch);
    dq_ws_kernel<DQK, DV><<<grid, kWsThreads, bytes, stream>>>(
        qm, dom, km, vm, scratch, static_cast<bf16*>(dq), sq, skv, heads,
        kv_heads, causal, window, scale, pair_heads);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* scratch,
           void* dq, void* dk, void* dv, int batch, int sq, int skv,
           int heads, int kv_heads, int causal, int window,
           cudaStream_t stream) {
  if (dtype == 1)
    return launch_bf16<DQK, DV>(q, k, v, o, dout, lse, scratch, dq, dk, dv,
                                batch, sq, skv, heads, kv_heads, causal,
                                window, stream);
  return launch_f32<DQK, DV>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, scratch, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), batch, sq, skv, heads,
      kv_heads, causal, window, stream);
}

// the head-dim pairs (q and k, v) the entry point launches
bool launched_pair(int dqk, int dv) {
  return (dqk == dv && (dqk == 64 || dqk == 128 || dqk == 256)) ||
         (dqk == 192 && dv == 128);
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16, of q, k, v, o, dout, dq, dk and dv;
// (head_dim, head_dim_v) the columns of q, k, dq and dk, and of v, o, dout
// and dv: (64, 64), (128, 128), (256, 256) or (192, 128), any other pair
// returning cudaErrorInvalidValue and launching nothing; q, dq (B, Sq, H,
// head_dim), o, dout (B, Sq, H, head_dim_v), k, dk (B, Skv, K, head_dim),
// v, dv (B, Skv, K, head_dim_v), contiguous, starting on 16 bytes; lse (B,
// H, Sq) float32; the scratch `delta` lotaru_flash_bwd_scratch_floats
// float32 elements, starting on 16 bytes.  bfloat16: the rows pass, dK/dV
// (and the partials' sum with head splits) and dQ; float32: D, dK/dV and
// dQ; all on `stream`.  bfloat16 returns cudaErrorInvalidValue, launching
// nothing, where a pass's shared memory is above the card's opt-in limit.
int lotaru_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int dtype, int batch,
                               int sq, int skv, int heads, int kv_heads,
                               int head_dim, int head_dim_v, int causal,
                               int window, cudaStream_t stream) {
  if (batch == 0) return 0;
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (head_dim == 192 && head_dim_v == 128)
    return launch<192, 128>(dtype, q, k, v, o, dout, l, d, dq, dk, dv, batch,
                            sq, skv, heads, kv_heads, causal, window, stream);
  if (head_dim_v != head_dim) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64:
      return launch<64, 64>(dtype, q, k, v, o, dout, l, d, dq, dk, dv, batch,
                            sq, skv, heads, kv_heads, causal, window, stream);
    case 128:
      return launch<128, 128>(dtype, q, k, v, o, dout, l, d, dq, dk, dv,
                              batch, sq, skv, heads, kv_heads, causal, window,
                              stream);
    case 256:
      return launch<256, 256>(dtype, q, k, v, o, dout, l, d, dq, dk, dv,
                              batch, sq, skv, heads, kv_heads, causal, window,
                              stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the backward's shape formulas, for the Python mirrors
// (kernels/flash_attention.bwd_smem_bytes, bwd_stages, bwd_head_splits,
// bwd_scratch_floats) to be held against, at a head-dim pair; -1 at a pair
// the entry point does not launch.  Dynamic shared memory of the dK/dV
// (which 0) and dQ (which 1) kernels by dtype (0 float32, 1 bfloat16)
int lotaru_flash_bwd_smem_bytes(int head_dim, int head_dim_v, int which,
                                int dtype) {
  if (!launched_pair(head_dim, head_dim_v)) return -1;
  if (dtype == 1)
    return which == 0 ? dkdv_smem_bytes(head_dim, head_dim_v)
                      : dq_smem_bytes(head_dim, head_dim_v);
  switch (head_dim) {
    case 64: return smem_bytes<64, 64>(which);
    case 128: return smem_bytes<128, 128>(which);
    case 192: return smem_bytes<192, 128>(which);
    default: return smem_bytes<256, 256>(which);
  }
}

// the stages of the bf16 dK/dV pass's Q/dO ring (which 0) and the dQ
// pass's K/V ring (which 1)
int lotaru_flash_bwd_stages(int head_dim, int head_dim_v, int which) {
  if (!launched_pair(head_dim, head_dim_v)) return -1;
  return which == 0 ? dkdv_stages(head_dim, head_dim_v)
                    : dq_stages(head_dim, head_dim_v);
}

int lotaru_flash_bwd_head_splits(int batch, int skv, int heads, int kv_heads,
                                 int sms, int head_dim, int head_dim_v) {
  if (!launched_pair(head_dim, head_dim_v)) return -1;
  return head_splits(batch, skv, heads, kv_heads, sms, head_dim);
}

long long lotaru_flash_bwd_scratch_floats(int dtype, int batch, int sq,
                                          int skv, int heads, int kv_heads,
                                          int head_dim, int head_dim_v,
                                          int sms) {
  if (!launched_pair(head_dim, head_dim_v)) return -1;
  return scratch_floats(dtype, batch, sq, skv, heads, kv_heads, head_dim,
                        head_dim_v, sms);
}

}  // extern "C"
