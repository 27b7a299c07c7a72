// Hand-written Hopper kernels for causal and sliding-window attention with
// grouped (GQA/MQA) key-value heads: the prefill attention of the local
// attention blocks of RecurrentGemma (window 2048, one kv head), of every
// full and sliding-window attention layer, and of DeepSeek-V2's multi-head
// latent attention in its expanded form (q and k of head dim 192, v of
// 128).  Built by nvcc into a plain-C shared library and bound with ctypes
// (see kernels/_build.py).
//
// Both kernels are templates on a head-dim pair <DQK, DV>: q and k have
// DQK columns, v and the output DV.  The entry point launches the pairs
// (64, 64), (128, 128), (256, 256) and (192, 128) and refuses any other.
//
// Two kernels compute the same function, chosen by the input type:
// bfloat16 (the model's type) runs on the tensor cores through wgmma,
// float32 on the CUDA cores in float32 throughout.
//
// Build flags: kernels/_build.NVCC_FLAGS, shared by every source
// (-gencode arch=compute_90a,code=sm_90a -O3 --fmad=false).  The bitwise
// kernels of the other sources need --fmad=false; these two are held to a
// tolerance against their plain version and do not depend on it.  The C
// entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
//
// Both replace the TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): softmax(q k^T / sqrt(DQK)) v with the
// causal mask and, for window > 0, only the last `window` keys visible;
// query head h reads kv head h * K / H; the running max, sum and output in
// float32; the output in q's type.  As the TPU kernel skips fully masked
// blocks, a block walks only the kv tiles of its band
// [max(0, q_lo - window + 1), min(q_hi, Skv)).  The kv head index comes
// from the grid, so MQA/GQA never copies K or V.  Rows and keys past the
// sequence end (S is any length) are masked like the band.  Blocks take
// their query tile in reverse, so the longest tiles of the causal band
// start first.  Masked scores are -1e30, as in the reference.
//
// Bound on the H100: operations.  At RecurrentGemma-9B's prefill (S = 4096,
// window 2048, hd = 256) every query sees up to 2048 keys and every
// (query, key) pair costs 4 * hd operations, about 400 per byte moved.

#include <math.h>

#include "hopper.cuh"   // TMA, mbarriers, descriptors, wgmma, tile kinds

namespace {

// ---------------------------------------------------------------------------
// bfloat16: a warp-specialised block, TMA loads, wgmma
// ---------------------------------------------------------------------------
// A block of three warpgroups, one producer and two consumers, one block per
// SM.  The consumers share every K and V tile the producer loads:
//   * heads pairing, when H / K is even: consumer c takes query head
//     2 * blockIdx.y + c over the same 64 query rows; both read one kv head;
//   * tiles pairing, otherwise (MHA, an odd group): both take one head, over
//     two consecutive 64-row query tiles.
// Either way a K/V tile is loaded once for 128 query rows.
//
// The producer: one thread issues TMA loads of 64-row boxes, 64 columns
// (128 bytes) wide, with the 128-byte swizzle, from 4-d tensor maps over
// (hd, heads, S, B): S is a dimension of its own, so the zero fill past S
// holds per batch and a tile past the end of batch b never reads batch
// b + 1.  Q once per block (one mbarrier), then each K and V tile of the
// block's band into a ring of flash_stages(hd) stages, each guarded by a
// full mbarrier (expect_tx of the tile's bytes) and an empty one (an
// arrival from each consumer warp once its products have read the stage).
// setmaxnreg gives the producer 40 registers and each consumer 232.
//
// A consumer, per kv tile: S = Q K^T as DQK / 16 wgmma m64n64k16 with both
// operands K-major in shared memory; the online softmax in base 2 on the
// accumulator fragment (row statistics over the 4 threads of a row; a tile
// wholly inside the band takes no per-element mask, see tile_kind); P
// rounded to bfloat16 in registers (as the TPU kernel casts p to v's type)
// and repacked as the A fragments of O += P V, four wgmma m64n{DV}k16 with
// V the B operand, MN-major (the transpose bit).  The 64 x DV float32
// accumulator stays in registers: 128 a thread at DV = 256.  At the pair
// (192, 128) a Q or K tile is three swizzled boxes and a V tile two.
// Ping-pong scheduling of the two consumers and a persistent grid are later
// work.
constexpr int kWsThreads = 384;          // producer + two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 40 * 128 + 232 * 256 = 64,512

// Stages of the K/V ring: two at DQK = 256 (all that fits beside Q), four
// below (kernels/flash_attention.flash_stages).
__host__ __device__ constexpr int flash_stages(int dqk) {
  return dqk == 256 ? 2 : 4;
}

// Dynamic shared memory of the bf16 kernel: Q for both consumers (64 rows
// of DQK bfloat16 each) and a ring of `stages` K tiles (64 x DQK) and V
// tiles (64 x DV); 1024 bytes of slack so that the tiles start on the
// 1024-byte period of the swizzle; 128 for the mbarriers
// (kernels/flash_attention.flash_smem_bytes).  214,144 bytes at (192, 128)
// and 4 stages, under the card's 232,448.
__host__ __device__ constexpr int flash_smem_bytes(int dqk, int dv,
                                                   int stages) {
  return (2 * dqk + stages * (dqk + dv)) * kBlockK * 2 + 1024 + 128;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_attention_ws_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ out, int sq, int skv,
                          int heads, int kv_heads, int causal, int window,
                          float scale_log2, int pair_heads,
                          float* __restrict__ lse) {
  constexpr int kStages = flash_stages(DQK);
  constexpr int kTile = kBlockK * DQK * 2;     // bytes of a 64-row Q/K tile
  constexpr int kTileV = kBlockK * DV * 2;     // and of a V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q of 0, 1
  const uint32_t k_s = q_s + 2 * kTile;                        // K ring
  const uint32_t v_s = k_s + kStages * kTile;                  // V ring
  const uint32_t bar_q = v_s + kStages * kTileV;
  const uint32_t bar_full = bar_q + 8;                         // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;           // [kStages]

  const int wg = threadIdx.x >> 7;
  const int b = blockIdx.z;
  const int tile = gridDim.x - 1 - blockIdx.x;   // the longest bands first
  // consumer c's query head and first row (arithmetic, not an array
  // indexed by the warpgroup, which would live in local memory)
  const int head0 = pair_heads ? 2 * blockIdx.y : blockIdx.y;
  const int head_step = pair_heads ? 1 : 0;
  const int q_lo0 = (pair_heads ? tile : 2 * tile) * kBlockQ;
  const int q_step = pair_heads ? 0 : kBlockQ;
  const int kvh = (int)((long long)head0 * kv_heads / heads);
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
      mbar_expect_tx(bar_q, n_q * kTile);
      for (int c = 0; c < n_q; ++c)
        tma_tile<DQK>(q_s + c * kTile, &qmap, bar_q, head0 + c * head_step,
                      q_lo0 + c * q_step, b);
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
  const int g = lane >> 2;           // the fragment's row within 8
  const int t = lane & 3;            // the fragment's column pair
  const int my_head = head0 + c * head_step;
  const int my_lo = q_lo0 + c * q_step;
  const int my_hi = min(my_lo + kBlockQ, sq);
  const uint32_t qt = q_s + c * kTile;
  const int row0 = my_lo + warp * 16 + g;        // rows row0 and row0 + 8

  // accumulator fragment: o[4 n + e] is row row0 + 8 (e >> 1), column
  // 8 n + 2 t + (e & 1); the scores sc[] the same over 64 keys
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};           // this thread's share of each row sum

  mbar_wait(bar_q, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = lo + it * kBlockK;
    const int s = it % kStages;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    const int kind = tile_kind(my_lo, my_hi, j0, skv, causal, window);
    if (kind != kSkip) {
      float sc[32];
      qk_product<DQK>(sc, qt, k_s + s * kTile);

      // base-2 logits; masked pairs at the reference's -1e30
      if (kind == kFull) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qpos = row0 + ((i >> 1) & 1) * 8;
          const int kpos = j0 + (i >> 2) * 8 + t * 2 + (i & 1);
          sc[i] = visible(qpos, kpos, skv, causal, window)
                      ? sc[i] * scale_log2 : kNegInf;
        }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // P as the A fragments of four k-steps of 16 keys
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
      pv_product<DV>(o, pa, v_s + s * kTileV);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + r * 8;
    if (row >= my_hi) continue;
    if (lse != nullptr && t == 0)
      lse[((long long)b * heads + my_head) * sq + row] =
          (m[r] + log2f(l[r])) * kLn2;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        out + (((long long)b * sq + row) * heads + my_head) * DV;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(o[4 * n + 2 * r] / denom, o[4 * n + 2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
// One block of 256 threads per (batch, head, 64-query tile); the
// online-softmax state (m, l and the 64 x DV accumulator) in registers:
// each thread owns 4 query rows, a 4 x 4 tile of the scores and a
// 4 x DV/16 tile of the output.  The query tile (scaled) and each key tile
// are staged in shared memory transposed, so that a thread reads 4
// queries and 4 keys of one head dimension as two 16-byte loads; each
// value tile and the probabilities are staged too.  (256, 256) takes
// 217 KB of shared memory, so one block runs per SM; (192, 128) 151 KB.
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kPad = kBlockQ + 4;    // row length of the transposed tiles

template <int DQK, int DV>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (2 * DQK * kPad + kBlockK * DV + kBlockK * kPad) * 4;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int sq, int skv,
                           int heads, int kv_heads, int causal, int window,
                           float scale, float* __restrict__ lse) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // [DQK][kPad]  query tile, transposed
  float* kt = qt + DQK * kPad;       // [DQK][kPad]  key tile, transposed
  float* vs = kt + DQK * kPad;       // [kBlockK][DV] value tile
  float* ps = vs + kBlockK * DV;     // [kBlockK][kPad] probabilities

  constexpr int kCols = DV / 64;     // float4 column groups of a thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = (int)((long long)h * kv_heads / heads);
  const int q_hi = min(q_lo + kBlockQ, sq);
  const long long q_stride = (long long)heads * DQK;
  const long long o_stride = (long long)heads * DV;
  const long long k_stride = (long long)kv_heads * DQK;
  const long long v_stride = (long long)kv_heads * DV;
  const float* qb = q + ((long long)b * sq) * q_stride + (long long)h * DQK;
  const float* kb = k + ((long long)b * skv) * k_stride + (long long)kvh * DQK;
  const float* vb = v + ((long long)b * skv) * v_stride + (long long)kvh * DV;

  for (int idx = tid; idx < kBlockQ * DQK; idx += kThreads) {
    const int r = idx / DQK, d = idx - r * DQK;
    const int row = q_lo + r;
    qt[d * kPad + r] = row < sq ? qb[row * q_stride + d] * scale : 0.f;
  }

  float m[4], l[4], o[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) o[i][c] = 0.f;
  }

  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = causal ? min(q_hi, skv) : skv;
  for (int j0 = kv_lo; j0 < kv_hi; j0 += kBlockK) {
    __syncthreads();   // the previous tile's kt, vs and ps are consumed
    for (int idx = tid; idx < kBlockK * DQK; idx += kThreads) {
      const int c = idx / DQK, d = idx - c * DQK;
      const int key = j0 + c;
      kt[d * kPad + c] = key < skv ? kb[key * k_stride + d] : 0.f;
    }
    for (int idx = tid; idx < kBlockK * DV; idx += kThreads) {
      const int c = idx / DV, d = idx - c * DV;
      const int key = j0 + c;
      vs[c * DV + d] = key < skv ? vb[key * v_stride + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[d * kPad + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&kt[d * kPad + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * ka[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = j0 + tx * 4 + j;
        s[i][j] = visible(qpos, kpos, skv, causal, window) ? s[i][j]
                                                           : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) o[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(tx * 4 + j) * kPad + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBlockK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&ps[c * kPad + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int gi = 0; gi < kCols; ++gi) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[c * DV + gi * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][gi * 4 + 0] += pa[i] * vv.x;
          o[i][gi * 4 + 1] += pa[i] * vv.y;
          o[i][gi * 4 + 2] += pa[i] * vv.z;
          o[i][gi * 4 + 3] += pa[i] * vv.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty * 4 + i;
    if (row >= sq) continue;
    if (lse != nullptr && tx == 0)
      lse[((long long)b * heads + h) * sq + row] = m[i] + logf(l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow =
        out + ((long long)b * sq + row) * o_stride + (long long)h * DV;
#pragma unroll
    for (int gi = 0; gi < kCols; ++gi)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[gi * 64 + tx * 4 + e] = o[i][gi * 4 + e] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int batch, int sq, int skv, int heads, int kv_heads,
                int causal, int window, float* lse, cudaStream_t stream) {
  const int bytes = flash_smem_bytes(DQK, DV, flash_stages(DQK));
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > optin) return static_cast<int>(cudaErrorInvalidValue);
  // with no keys no tile is loaded; the maps need a row and a base all the
  // same, so an empty K and V map q's
  const int rows = skv > 0 ? skv : 1;
  CUtensorMap qm, km, vm;
  int rc = bf16_map(&qm, q, DQK, heads, sq, batch);
  if (rc == 0)
    rc = bf16_map(&km, skv > 0 ? k : q, DQK, kv_heads, rows, batch);
  if (rc == 0)      // DV <= DQK: an empty V's map stays inside q
    rc = bf16_map(&vm, skv > 0 ? v : q, DV, kv_heads, rows, batch);
  if (rc != 0) return rc;
  auto kernel = flash_attention_ws_kernel<DQK, DV>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pair_heads = (heads / kv_heads) % 2 == 0;
  const int rows_a_block = pair_heads ? kBlockQ : 2 * kBlockQ;
  const dim3 grid((sq + rows_a_block - 1) / rows_a_block,
                  pair_heads ? heads / 2 : heads, batch);
  const float scale = 1.0f / sqrtf((float)DQK);
  kernel<<<grid, kWsThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), sq, skv, heads,
      kv_heads, causal, window, scale * kLog2e, pair_heads, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int batch, int sq, int skv, int heads, int kv_heads,
               int causal, int window, float* lse, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  auto kernel = flash_attention_f32_kernel<DQK, DV>;
  const int bytes = f32_smem_bytes<DQK, DV>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv,
      heads, kv_heads, causal, window, 1.0f / sqrtf((float)DQK), lse);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* out, int dtype,
           int batch, int sq, int skv, int heads, int kv_heads, int causal,
           int window, float* lse, cudaStream_t stream) {
  return dtype == 1
             ? launch_bf16<DQK, DV>(q, k, v, out, batch, sq, skv, heads,
                                    kv_heads, causal, window, lse, stream)
             : launch_f32<DQK, DV>(q, k, v, out, batch, sq, skv, heads,
                                   kv_heads, causal, window, lse, stream);
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16; (head_dim, head_dim_v) the columns of q
// and k, and of v and the output: (64, 64), (128, 128), (256, 256) or
// (192, 128); any other pair returns cudaErrorInvalidValue.  bfloat16 rows
// must start on 16 bytes (the wrapper checks the pointers).  bfloat16
// asks for flash_smem_bytes of shared memory and returns
// cudaErrorInvalidValue, launching nothing, where that is above the card's
// opt-in limit.  lse, when not null, receives each row's log-sum-exp of
// its scaled scores, (batch, heads, sq) float32, for the backward; the
// serve path passes null and its launches store nothing more.
int lotaru_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int dtype, int batch, int sq, int skv,
                           int heads, int kv_heads, int head_dim,
                           int head_dim_v, int causal, int window, void* lse,
                           cudaStream_t stream) {
  float* lse_f = static_cast<float*>(lse);
  if (sq == 0 || batch == 0) return 0;
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 192 && head_dim_v == 128)
    return launch<192, 128>(q, k, v, out, dtype, batch, sq, skv, heads,
                            kv_heads, causal, window, lse_f, stream);
  if (head_dim_v != head_dim) return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64:
      return launch<64, 64>(q, k, v, out, dtype, batch, sq, skv, heads,
                            kv_heads, causal, window, lse_f, stream);
    case 128:
      return launch<128, 128>(q, k, v, out, dtype, batch, sq, skv, heads,
                              kv_heads, causal, window, lse_f, stream);
    case 256:
      return launch<256, 256>(q, k, v, out, dtype, batch, sq, skv, heads,
                              kv_heads, causal, window, lse_f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the bf16 kernel's formulas, for the Python mirrors to be held against
long long lotaru_flash_smem_bytes(int head_dim, int head_dim_v, int stages) {
  return flash_smem_bytes(head_dim, head_dim_v, stages);
}

int lotaru_flash_stages(int head_dim) { return flash_stages(head_dim); }

int lotaru_flash_tile_kind(int q_lo, int q_hi, int j0, int skv, int causal,
                           int window) {
  return tile_kind(q_lo, q_hi, j0, skv, causal, window);
}

}  // extern "C"
