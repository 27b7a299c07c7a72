// Hand-written Hopper kernels for the backward pass of causal and
// sliding-window attention with grouped (GQA/MQA) key-value heads: the
// gradient of kernels/csrc/flash_attention.cu's function, for training.
// Built by nvcc into a plain-C shared library and bound with ctypes (see
// kernels/_build.py).
//
// No TPU kernel is replaced: the JAX package differentiates its plain-XLA
// chunked_causal_attention (repro/models/attention.py), and these kernels
// compute that gradient.  The forward's kernels write each row's
// log-sum-exp lse of its scaled scores; given q, k, v, the output o, its
// gradient dO and lse, three launches give dq, dk and dv:
//   1. delta_kernel: D_i = sum_d dO_id O_id, float32, one warp a row;
//   2. dkdv_kernel: one block a (batch, kv head, key tile).  It walks every
//      query head of its group and the query tiles that may see its keys,
//      recomputes P = exp(S - lse) and accumulates dV += P^T dO and
//      dK += dS^T Q with dS = P (dO V^T - D), all in float32 registers
//      (each query tile's share summed apart, then added);
//   3. dq_kernel: one block a (batch, head, query tile) over the key tiles
//      of its band: dQ += dS K.
// The sum over a group's query heads happens inside one block and every
// output element is written once, so there are no atomics and two launches
// give bitwise equal results.
//
// Two routes (kernels/flash_attention.bwd_route).  bfloat16 runs on the
// tensor cores (mma.sync m16n8k16, float32 accumulation; see the section
// below).  float32 runs on the CUDA cores in float32: each tile is staged
// in shared memory both transposed (for the score products, which sum over
// hd) and row-major (for the accumulations, which sum over rows); a thread
// owns a small register tile of scores and one of the accumulators, and
// the inner loops read 16-byte vectors of shared memory.  Bound on the
// H100: operations (10 hd a visible pair: S, dP, dV, dK and dQ; the
// kernels compute S and dP twice, in the dK/dV and the dQ pass), far above
// the bytes.  A wgmma redesign with TMA-staged tiles is later work.
//
// Build flags: kernels/_build.NVCC_FLAGS (-O3 --fmad=false); held to a
// tolerance against kernels/ref.py::attention_bwd_ref.  The C entry point
// launches on the caller's stream, does not synchronise, allocates nothing
// (the delta scratch comes from the wrapper), and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;            // 16 x 16
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// 1. D = rowsum(dO * O), (B, H, Sq) float32; one warp a (b, row, head)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, int batch, int sq, int heads) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * sq * heads) return;
  const T* op = o + row * D;
  const T* dp = dout + row * D;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) sum += to_f(op[d]) * to_f(dp[d]);
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
// Shared memory (floats): K and V transposed [D][BK + 4]; Q and dO
// transposed [D][BQ + 4] and row-major [BQ][D + 4]; P and dS [BQ][BK + 4];
// lse (base 2) and D for BQ rows.  The 4 floats of padding a row keep
// 16-byte vectors aligned and spread a warp's stores over the banks.
template <int D, int BK, int BQ>
__host__ __device__ constexpr int dkdv_smem_floats() {
  return 2 * D * (BK + 4) + 2 * D * (BQ + 4) + 2 * BQ * (D + 4) +
         2 * BQ * (BK + 4) + 2 * BQ;
}

template <int D, int BK, int BQ>
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
  float* kt = smem;                      // [D][LK]
  float* vt = kt + D * LK;               // [D][LK]
  float* qt = vt + D * LK;               // [D][LQ]
  float* dot = qt + D * LQ;              // [D][LQ]
  float* qr = dot + D * LQ;              // [BQ][D + 4]
  float* dor = qr + BQ * (D + 4);        // [BQ][D + 4]
  float* ps = dor + BQ * (D + 4);        // [BQ][LK]
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

  const float* kb = k + (long long)b * skv * kv_heads * D;
  const float* vb = v + (long long)b * skv * kv_heads * D;
  stage<D, BK>(kb, skv, kv_heads, kvh, k0, kt, LK, nullptr);
  stage<D, BK>(vb, skv, kv_heads, kvh, k0, vt, LK, nullptr);

  float acc_k[RK][D / 16], acc_v[RK][D / 16];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the query rows that may see a key of [k0, k1)
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k1 - 1 + window) : sq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const float* qb = q + (long long)b * sq * heads * D;
    const float* db = dout + (long long)b * sq * heads * D;
    const float* lb = lse + ((long long)b * heads + h) * sq;
    const float* deb = delta + ((long long)b * heads + h) * sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // the previous tile's q, dO, P and dS are consumed
      stage<D, BQ>(qb, sq, heads, h, q0, qt, LQ, qr);
      stage<D, BQ>(db, sq, heads, h, q0, dot, LQ, dor);
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
      tile_product<RK, RQ, D>(s, kt + ty * RK, LK, qt + tx * RQ, LQ);
      tile_product<RK, RQ, D>(dp, vt + ty * RK, LK, dot + tx * RQ, LQ);
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
      float part_k[RK][D / 16], part_v[RK][D / 16];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c) part_k[i][c] = part_v[i][c] = 0.f;
      accumulate<RK, D, BQ>(part_v, ps + ty * RK, LK, dor + tx * 4);
      accumulate<RK, D, BQ>(part_k, dss + ty * RK, LK, qr + tx * 4);
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          acc_k[i][c] += part_k[i][c];
          acc_v[i][c] += part_v[i][c];
        }
    }
  }

  float* dkb = dk + (long long)b * skv * kv_heads * D;
  float* dvb = dv + (long long)b * skv * kv_heads * D;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty * RK + i;
    if (key >= skv) continue;
    const long long off = ((long long)key * kv_heads + kvh) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const int col = g * 64 + tx * 4;
      store4(dkb + off + col,
             make_float4(acc_k[i][g * 4] * scale, acc_k[i][g * 4 + 1] * scale,
                         acc_k[i][g * 4 + 2] * scale,
                         acc_k[i][g * 4 + 3] * scale));
      store4(dvb + off + col,
             make_float4(acc_v[i][g * 4], acc_v[i][g * 4 + 1],
                         acc_v[i][g * 4 + 2], acc_v[i][g * 4 + 3]));
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block a (batch, head, BQ-query tile)
// ---------------------------------------------------------------------------
// Shared memory (floats): Q and dO transposed [D][BQ + 4]; K and V
// transposed [D][BK + 4]; K row-major [BK][D + 4]; dS transposed
// [BK][BQ + 4]; lse (base 2) and D for BQ rows.
template <int D, int BQ, int BK>
__host__ __device__ constexpr int dq_smem_floats() {
  return 2 * D * (BQ + 4) + 2 * D * (BK + 4) + BK * (D + 4) +
         BK * (BQ + 4) + 2 * BQ;
}

template <int D, int BQ, int BK>
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
  float* qt = smem;                      // [D][LQ]
  float* dot = qt + D * LQ;              // [D][LQ]
  float* kt = dot + D * LQ;              // [D][LK]
  float* vt = kt + D * LK;               // [D][LK]
  float* kr = vt + D * LK;               // [BK][D + 4]
  float* dst = kr + BK * (D + 4);        // [BK][LQ]
  float* lse_s = dst + BK * LQ;          // [BQ], base 2
  float* dl_s = lse_s + BQ;              // [BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest bands first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = (int)((long long)h * kv_heads / heads);
  const int q1 = min(q0 + BQ, sq);
  const float scale_log2 = scale * kLog2e;

  stage<D, BQ>(q + (long long)b * sq * heads * D, sq, heads, h, q0, qt,
                  LQ, nullptr);
  stage<D, BQ>(dout + (long long)b * sq * heads * D, sq, heads, h, q0,
                  dot, LQ, nullptr);
  const float* lb = lse + ((long long)b * heads + h) * sq;
  const float* deb = delta + ((long long)b * heads + h) * sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int row = q0 + r;
    lse_s[r] = row < sq ? lb[row] * kLog2e : 0.f;
    dl_s[r] = row < sq ? deb[row] : 0.f;
  }

  float acc[RQ][D / 16];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const float* kb = k + (long long)b * skv * kv_heads * D;
  const float* vb = v + (long long)b * skv * kv_heads * D;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(q1, skv) : skv;
  for (int j0 = lo; j0 < hi; j0 += BK) {
    __syncthreads();   // the previous tile's K, V and dS are consumed
    stage<D, BK>(kb, skv, kv_heads, kvh, j0, kt, LK, kr);
    stage<D, BK>(vb, skv, kv_heads, kvh, j0, vt, LK, nullptr);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<RQ, RK, D>(s, qt + ty * RQ, LQ, kt + tx * RK, LK);
    tile_product<RQ, RK, D>(dp, dot + ty * RQ, LQ, vt + tx * RK, LK);
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
    accumulate<RQ, D, BK>(acc, dst + ty * RQ, LQ, kr + tx * 4);
  }

  float* dqb = dq + (long long)b * sq * heads * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= sq) continue;
    const long long off = ((long long)row * heads + h) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      store4(dqb + off + g * 64 + tx * 4,
             make_float4(acc[i][g * 4] * scale, acc[i][g * 4 + 1] * scale,
                         acc[i][g * 4 + 2] * scale,
                         acc[i][g * 4 + 3] * scale));
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the same three passes on the tensor cores (mma.sync)
// ---------------------------------------------------------------------------
// Blocks of four warps, each warp owning 16 rows of the block's 64 (keys
// for dK/dV, queries for dQ) and, for one chunk of 64 output columns,
// their accumulators in registers: at hd 64 a block computes all its
// rows' columns, at hd 128 and 256 the grid holds one block a chunk, each
// recomputing the scores over the whole head dim (the accumulators of all
// 256 columns would not fit a thread's registers).  Tiles stay bfloat16
// in shared memory, rows padded by 8 elements so that a fragment's 32-bit
// loads fall in distinct banks; the operand that a product sums over rows
// (Q and dO for dK/dV, K for dQ) is also staged transposed, for the
// block's chunk of columns.  At hd 64 a warp holds its K and V (or Q and
// dO) fragments in registers for the whole walk; wider, it reads them from
// shared memory.  Each product is mma.sync m16n8k16 with float32
// accumulation.  P and dS, the A operands of the second products (dV, dK,
// dQ), come straight from the accumulator fragments, each split into a
// bfloat16 part and the bfloat16 rounding of its remainder, two products
// each: 16 bits of their float32 mantissa reach the tensor cores (with one
// bfloat16 rounding of P and dS, dK moved by up to 2 % of the float32
// route's value).  Every other step is the float32 route's.
constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;          // a block's keys (dK/dV) or queries (dQ)
constexpr int kMmaTile = 64;          // a tile's queries (dK/dV) or keys (dQ)
constexpr int kMmaCols = 64;          // output columns of a block

template <int D>
__host__ __device__ constexpr int mma_smem_bytes(int which) {
  // dK/dV: K, V, Q, dO row-major and a chunk of Q, dO transposed; dQ: Q,
  // dO, K, V row-major and a chunk of K transposed; lse and D for 64 rows
  return which == 0
             ? (4 * kMmaRows * (D + 8) + 2 * kMmaCols * (kMmaTile + 8)) * 2 +
                   512
             : (4 * kMmaRows * (D + 8) + kMmaCols * (kMmaTile + 8)) * 2 + 512;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 as a bfloat16 pair and the pair of their remainders' roundings
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(x0 - hf.x, x1 - hf.y);
}

// the A fragments (both parts) of k-step kk of a warp's 16-row block of
// accumulator fragments x[n-tile][element], its columns the product's k
template <int N>
__device__ __forceinline__ void frag_split(const float (&x)[N][4], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
  split2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
  split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
  split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
}

// the A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major tile with rows of ld elements
__device__ __forceinline__ void frag_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int r0, int c0, int g, int t) {
  a[0] = ld32(s + (r0 + g) * ld + c0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + c0 + 2 * t + 8);
  a[3] = ld32(s + (r0 + g + 8) * ld + c0 + 2 * t + 8);
}

// acc (16 x 8 at column tile n0) += A (16 x 16) B, with B stored n-major:
// bt[n * ld + k], the k-step starting at column k0
__device__ __forceinline__ void mma_nt(float (&acc)[4], const uint32_t (&a)[4],
                                       const __nv_bfloat16* bt, int ld,
                                       int n0, int k0, int g, int t) {
  const __nv_bfloat16* p = bt + (n0 + g) * ld + k0 + 2 * t;
  mma16816(acc, a, ld32(p), ld32(p + 8));
}

// A warp's two A operands of 16 rows x D: held in registers at hd 64 (the
// whole walk reuses them), read from the shared tiles at each k-step wider
template <int D>
struct RowFrags {
  static constexpr bool kHeld = D == 64;
  uint32_t a[kHeld ? D / 16 : 1][4], b[kHeld ? D / 16 : 1][4];
  const __nv_bfloat16 *sa, *sb;
  int r0, g, t;

  __device__ __forceinline__ RowFrags(const __nv_bfloat16* sa_,
                                      const __nv_bfloat16* sb_, int r0_,
                                      int g_, int t_)
      : sa(sa_), sb(sb_), r0(r0_), g(g_), t(t_) {
    if constexpr (kHeld) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        frag_a(a[kk], sa, D + 8, r0, kk * 16, g, t);
        frag_a(b[kk], sb, D + 8, r0, kk * 16, g, t);
      }
    }
  }

  __device__ __forceinline__ void get(int kk, uint32_t (&fa)[4],
                                      uint32_t (&fb)[4]) const {
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fa[i] = a[kk][i];
        fb[i] = b[kk][i];
      }
    } else {
      frag_a(fa, sa, D + 8, r0, kk * 16, g, t);
      frag_a(fb, sb, D + 8, r0, kk * 16, g, t);
    }
  }
};

// rows [r0, r0 + 64) of one head of a (B, S, heads, D) bf16 tensor into a
// row-major tile [64][D + 8] and, when tr is not null, the columns
// [c0, c0 + 64) transposed into [64][64 + 8]; rows at or past s are zeros.
// A thread moves 8 elements (16 bytes) at a time; consecutive threads take
// consecutive rows, so the transposed stores of a warp fall in distinct
// banks.
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src,
                                           int s, int heads, int head, int r0,
                                           __nv_bfloat16* rm,
                                           __nv_bfloat16* tr, int c0) {
  const long long row_stride = (long long)heads * D;
  for (int idx = threadIdx.x; idx < kMmaRows * D / 8; idx += kMmaThreads) {
    const int r = idx % kMmaRows;
    const int c = idx / kMmaRows * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < s)
      v = *reinterpret_cast<const uint4*>(src + row * row_stride +
                                          (long long)head * D + c);
    *reinterpret_cast<uint4*>(rm + r * (D + 8) + c) = v;
    if (tr != nullptr && c >= c0 && c < c0 + kMmaCols) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        tr[(c - c0 + i) * (kMmaTile + 8) + r] = e[i];
    }
  }
}

// s += A B and dp += A' B' over the whole head dim for a warp's 16 rows
// and a tile's 64 columns: the scores (S or S^T) and dP (or dP^T)
template <int D>
__device__ __forceinline__ void score_tiles(float (&s)[kMmaTile / 8][4],
                                            float (&dp)[kMmaTile / 8][4],
                                            const RowFrags<D>& rows,
                                            const __nv_bfloat16* bs,
                                            const __nv_bfloat16* bdp, int g,
                                            int t) {
#pragma unroll
  for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4], fb[4];
    rows.get(kk, fa, fb);
#pragma unroll
    for (int j = 0; j < kMmaTile / 8; ++j) {
      mma_nt(s[j], fa, bs, D + 8, j * 8, kk * 16, g, t);
      mma_nt(dp[j], fb, bdp, D + 8, j * 8, kk * 16, g, t);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                int sq, int skv, int heads, int kv_heads, int causal,
                int window, float scale) {
  constexpr int LD = D + 8, LT = kMmaTile + 8, NC = D / kMmaCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kMmaRows * LD;
  __nv_bfloat16* qs = vs + kMmaRows * LD;
  __nv_bfloat16* dos = qs + kMmaTile * LD;
  __nv_bfloat16* qts = dos + kMmaTile * LD;      // [kMmaCols][LT]
  __nv_bfloat16* dots = qts + kMmaCols * LT;     // [kMmaCols][LT]
  float* lse_s = reinterpret_cast<float*>(dots + kMmaCols * LT);  // base 2
  float* dl_s = lse_s + kMmaTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kMmaRows;
  const int kvh = blockIdx.y / NC;
  const int c0 = blockIdx.y % NC * kMmaCols;     // the block's columns
  const int b = blockIdx.z;
  const int group = heads / kv_heads;
  const int k1 = min(k0 + kMmaRows, skv);
  const float scale_log2 = scale * kLog2e;

  stage_bf16<D>(k + (long long)b * skv * kv_heads * D, skv, kv_heads, kvh,
                k0, ks, nullptr, 0);
  stage_bf16<D>(v + (long long)b * skv * kv_heads * D, skv, kv_heads, kvh,
                k0, vs, nullptr, 0);
  __syncthreads();
  const RowFrags<D> kv(ks, vs, warp * 16, g, t);
  float acc_k[kMmaCols / 8][4], acc_v[kMmaCols / 8][4];
#pragma unroll
  for (int n = 0; n < kMmaCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq, k1 - 1 + window) : sq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const __nv_bfloat16* qb = q + (long long)b * sq * heads * D;
    const __nv_bfloat16* db = dout + (long long)b * sq * heads * D;
    const float* lb = lse + ((long long)b * heads + h) * sq;
    const float* deb = delta + ((long long)b * heads + h) * sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += kMmaTile) {
      __syncthreads();   // the previous tile's Q and dO are consumed
      stage_bf16<D>(qb, sq, heads, h, q0, qs, qts, c0);
      stage_bf16<D>(db, sq, heads, h, q0, dos, dots, c0);
      for (int r = threadIdx.x; r < kMmaTile; r += kMmaThreads) {
        const int row = q0 + r;
        lse_s[r] = row < sq ? lb[row] * kLog2e : 0.f;
        dl_s[r] = row < sq ? deb[row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
      float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
      score_tiles<D>(s, dp, kv, qs, dos, g, t);
      // P^T and dS^T in place; the fragment's element e is key row
      // g + 8 (e >> 1), query column 2 t + (e & 1) of its 8
#pragma unroll
      for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + warp * 16 + g + (e >> 1) * 8;
          const int ql = j * 8 + 2 * t + (e & 1);
          const float p = visible(q0 + ql, kpos, sq, skv, causal, window)
                              ? exp2f(s[j][e] * scale_log2 - lse_s[ql])
                              : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_s[ql]);
        }
      // dV += P^T dO and dK += dS^T Q on the block's columns, k-steps of
      // 16 queries
#pragma unroll
      for (int kq = 0; kq < kMmaTile / 16; ++kq) {
        uint32_t pa[4], pl[4], da[4], dl[4];
        frag_split(s, kq, pa, pl);
        frag_split(dp, kq, da, dl);
#pragma unroll
        for (int n = 0; n < kMmaCols / 8; ++n) {
          mma_nt(acc_v[n], pa, dots, LT, n * 8, kq * 16, g, t);
          mma_nt(acc_v[n], pl, dots, LT, n * 8, kq * 16, g, t);
          mma_nt(acc_k[n], da, qts, LT, n * 8, kq * 16, g, t);
          mma_nt(acc_k[n], dl, qts, LT, n * 8, kq * 16, g, t);
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + (long long)b * skv * kv_heads * D;
  __nv_bfloat16* dvb = dv + (long long)b * skv * kv_heads * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + warp * 16 + g + half * 8;
    if (key >= skv) continue;
    const long long off = ((long long)key * kv_heads + kvh) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kMmaCols / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + off + n * 8) =
          pack2(acc_k[n][2 * half] * scale, acc_k[n][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + off + n * 8) =
          pack2(acc_v[n][2 * half], acc_v[n][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int sq, int skv, int heads,
              int kv_heads, int causal, int window, float scale) {
  constexpr int LD = D + 8, LT = kMmaTile + 8, NC = D / kMmaCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kMmaRows * LD;
  __nv_bfloat16* ks = dos + kMmaRows * LD;
  __nv_bfloat16* vs = ks + kMmaTile * LD;
  __nv_bfloat16* kts = vs + kMmaTile * LD;       // [kMmaCols][LT]
  float* lse_s = reinterpret_cast<float*>(kts + kMmaCols * LT);   // base 2
  float* dl_s = lse_s + kMmaRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaRows;  // longest first
  const int h = blockIdx.y / NC;
  const int c0 = blockIdx.y % NC * kMmaCols;     // the block's columns
  const int b = blockIdx.z;
  const int kvh = (int)((long long)h * kv_heads / heads);
  const int q1 = min(q0 + kMmaRows, sq);
  const float scale_log2 = scale * kLog2e;

  stage_bf16<D>(q + (long long)b * sq * heads * D, sq, heads, h, q0, qs,
                nullptr, 0);
  stage_bf16<D>(dout + (long long)b * sq * heads * D, sq, heads, h, q0, dos,
                nullptr, 0);
  const float* lb = lse + ((long long)b * heads + h) * sq;
  const float* deb = delta + ((long long)b * heads + h) * sq;
  for (int r = threadIdx.x; r < kMmaRows; r += kMmaThreads) {
    const int row = q0 + r;
    lse_s[r] = row < sq ? lb[row] * kLog2e : 0.f;
    dl_s[r] = row < sq ? deb[row] : 0.f;
  }
  __syncthreads();
  const RowFrags<D> qd(qs, dos, warp * 16, g, t);
  float acc[kMmaCols / 8][4];
#pragma unroll
  for (int n = 0; n < kMmaCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const __nv_bfloat16* kb = k + (long long)b * skv * kv_heads * D;
  const __nv_bfloat16* vb = v + (long long)b * skv * kv_heads * D;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(q1, skv) : skv;
  for (int j0 = lo; j0 < hi; j0 += kMmaTile) {
    __syncthreads();   // the previous tile's K and V are consumed
    stage_bf16<D>(kb, skv, kv_heads, kvh, j0, ks, kts, c0);
    stage_bf16<D>(vb, skv, kv_heads, kvh, j0, vs, nullptr, 0);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float s[kMmaTile / 8][4], dp[kMmaTile / 8][4];
    score_tiles<D>(s, dp, qd, ks, vs, g, t);
    // dS in place; element e is query row g + 8 (e >> 1), key column
    // 2 t + (e & 1) of its 8
#pragma unroll
    for (int j = 0; j < kMmaTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = warp * 16 + g + (e >> 1) * 8;
        const int kpos = j0 + j * 8 + 2 * t + (e & 1);
        const float p = visible(q0 + ql, kpos, sq, skv, causal, window)
                            ? exp2f(s[j][e] * scale_log2 - lse_s[ql])
                            : 0.f;
        dp[j][e] = p * (dp[j][e] - dl_s[ql]);
      }
    // dQ += dS K on the block's columns, k-steps of 16 keys
#pragma unroll
    for (int kq = 0; kq < kMmaTile / 16; ++kq) {
      uint32_t da[4], dl[4];
      frag_split(dp, kq, da, dl);
#pragma unroll
      for (int n = 0; n < kMmaCols / 8; ++n) {
        mma_nt(acc[n], da, kts, LT, n * 8, kq * 16, g, t);
        mma_nt(acc[n], dl, kts, LT, n * 8, kq * 16, g, t);
      }
    }
  }

  __nv_bfloat16* dqb = dq + (long long)b * sq * heads * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + warp * 16 + g + half * 8;
    if (row >= sq) continue;
    const long long off = ((long long)row * heads + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kMmaCols / 8; ++n)
      *reinterpret_cast<uint32_t*>(dqb + off + n * 8) =
          pack2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// Tiles by head dim: 64 keys and 64 queries at hd 64; 64 keys and 32
// queries at hd 128; 32 and 32 at hd 256, where each staged tile of 32
// rows is 32 KB of float32 (bwd_smem_bytes; the largest, dK/dV at hd 256,
// is 223,488 bytes of the 232,448 a block may opt in to).
template <int D> struct Tiles;
template <> struct Tiles<64> { static constexpr int BK = 64, BQ = 64; };
template <> struct Tiles<128> { static constexpr int BK = 64, BQ = 32; };
template <> struct Tiles<256> { static constexpr int BK = 32, BQ = 32; };

template <int D>
int smem_bytes(int which) {
  constexpr int BK = Tiles<D>::BK, BQ = Tiles<D>::BQ;
  return 4 * (which == 0 ? dkdv_smem_floats<D, BK, BQ>()
                         : dq_smem_floats<D, BQ, BK>());
}

// the dK/dV and dQ kernels' launches: the mma.sync kernels for bfloat16,
// the float32 CUDA-core kernels for float32
template <typename T, int D>
int launch_passes(const T* qp, const T* kp, const T* vp, const T* dp,
                  const float* lse, const float* delta, T* dq, T* dk, T* dv,
                  int batch, int sq, int skv, int heads, int kv_heads,
                  int causal, int window, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (skv > 0) {
      const int bytes = mma_smem_bytes<D>(0);
      cudaError_t err = cudaFuncSetAttribute(
          dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((skv + kMmaRows - 1) / kMmaRows,
                      kv_heads * (D / kMmaCols), batch);
      dkdv_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
          qp, kp, vp, dp, lse, delta, dk, dv, sq, skv, heads, kv_heads,
          causal, window, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (sq > 0) {
      const int bytes = mma_smem_bytes<D>(1);
      cudaError_t err = cudaFuncSetAttribute(
          dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((sq + kMmaRows - 1) / kMmaRows, heads * (D / kMmaCols),
                      batch);
      dq_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
          qp, kp, vp, dp, lse, delta, dq, sq, skv, heads, kv_heads, causal,
          window, scale);
    }
    return static_cast<int>(cudaGetLastError());
  } else {
    constexpr int BK = Tiles<D>::BK, BQ = Tiles<D>::BQ;
    if (skv > 0) {
      auto kern = dkdv_kernel<D, BK, BQ>;
      const int bytes = smem_bytes<D>(0);
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((skv + BK - 1) / BK, kv_heads, batch);
      kern<<<grid, kThreads, bytes, stream>>>(
          qp, kp, vp, dp, lse, delta, dk, dv, sq, skv, heads, kv_heads,
          causal, window, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (sq > 0) {
      auto kern = dq_kernel<D, BQ, BK>;
      const int bytes = smem_bytes<D>(1);
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 grid((sq + BQ - 1) / BQ, heads, batch);
      kern<<<grid, kThreads, bytes, stream>>>(
          qp, kp, vp, dp, lse, delta, dq, sq, skv, heads, kv_heads, causal,
          window, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int batch, int sq, int skv, int heads,
           int kv_heads, int causal, int window, cudaStream_t stream) {
  const T* dp = static_cast<const T*>(dout);
  const long long rows = (long long)batch * sq * heads;
  if (rows > 0) {
    delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), kThreads, 0, stream>>>(
        static_cast<const T*>(o), dp, delta, batch, sq, heads);
  }
  return launch_passes<T, D>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), dp, lse, delta, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), batch, sq, skv, heads,
      kv_heads, causal, window, 1.0f / sqrtf((float)D), stream);
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, int batch,
                 int sq, int skv, int heads, int kv_heads, int causal,
                 int window, cudaStream_t stream) {
  return dtype == 1
             ? launch<__nv_bfloat16, D>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, batch, sq, skv, heads, kv_heads,
                                        causal, window, stream)
             : launch<float, D>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                batch, sq, skv, heads, kv_heads, causal,
                                window, stream);
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16, of q, k, v, o, dout, dq, dk and dv; head
// dim 64, 128 or 256; q, o, dout, dq (B, Sq, H, hd), k, v, dk, dv (B, Skv,
// K, hd), contiguous, starting on 16 bytes; lse and the scratch delta
// (B, H, Sq) float32.  Three launches (delta, dK/dV, dQ) on `stream`.
int lotaru_flash_attention_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int dtype, int batch,
                               int sq, int skv, int heads, int kv_heads,
                               int head_dim, int causal, int window,
                               cudaStream_t stream) {
  if (batch == 0) return 0;
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (head_dim) {
    case 64:
      return launch_dtype<64>(dtype, q, k, v, o, dout, l, d, dq, dk, dv,
                              batch, sq, skv, heads, kv_heads, causal, window,
                              stream);
    case 128:
      return launch_dtype<128>(dtype, q, k, v, o, dout, l, d, dq, dk, dv,
                               batch, sq, skv, heads, kv_heads, causal,
                               window, stream);
    case 256:
      return launch_dtype<256>(dtype, q, k, v, o, dout, l, d, dq, dk, dv,
                               batch, sq, skv, heads, kv_heads, causal,
                               window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dynamic shared memory of the dK/dV (which 0) and dQ (which 1) kernels at
// a head dim and dtype (0 float32, 1 bfloat16), for the Python mirror
// (kernels/flash_attention.bwd_smem_bytes)
int lotaru_flash_bwd_smem_bytes(int head_dim, int which, int dtype) {
  switch (head_dim) {
    case 64: return dtype == 1 ? mma_smem_bytes<64>(which)
                               : smem_bytes<64>(which);
    case 128: return dtype == 1 ? mma_smem_bytes<128>(which)
                                : smem_bytes<128>(which);
    case 256: return dtype == 1 ? mma_smem_bytes<256>(which)
                                : smem_bytes<256>(which);
    default: return -1;
  }
}

}  // extern "C"
