// Hand-written Hopper kernels for causal and sliding-window attention with
// grouped (GQA/MQA) key-value heads: the prefill attention of the local
// attention blocks of RecurrentGemma (window 2048, one kv head).  Built by
// nvcc into a plain-C shared library and bound with ctypes (see
// kernels/_build.py).
//
// Two kernels compute the same function, chosen by the input type:
// bfloat16 (the model's type) runs on the tensor cores, float32 on the CUDA
// cores in float32 throughout.
//
// Build flags: the shared ones (-gencode arch=compute_90a,code=sm_90a -O3)
// with --fmad=true: these kernels are held to a tolerance against their
// plain version, not bitwise, so multiply-adds may contract.  The C entry
// point launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().
//
// Both replace the TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): softmax(q k^T / sqrt(hd)) v with the
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // query rows of a block
constexpr int kBlockK = 64;        // keys of a kv tile
constexpr float kNegInf = -1e30f;  // the reference's mask value

__device__ __forceinline__ bool visible(int qpos, int kpos, int skv,
                                        int causal, int window) {
  bool vis = kpos < skv;
  if (causal) vis = vis && kpos <= qpos;
  if (window > 0) vis = vis && kpos > qpos - window;
  return vis;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulate)
// ---------------------------------------------------------------------------
// One block of 4 warps per (batch, head, 64-query tile); each warp owns 16
// query rows.  The query tile and each key and value tile sit in shared
// memory as they are in device memory (rows of hd, padded by 8 elements so
// that ldmatrix's eight 16-byte rows fall in distinct banks): 101 KB at
// hd = 256, two blocks per SM.  Per kv tile a warp computes its 16 x 64
// scores with mma.sync (A = q via ldmatrix, B = k via ldmatrix), masks and
// rescales them in registers (online softmax in base 2, the row statistics
// reduced over the 4 threads that share a row), and multiplies the
// probabilities, converted to bfloat16 in registers (as the TPU kernel
// casts p to v's type), by the value tile (B = v via ldmatrix.trans).  The
// 16 x hd float32 accumulator stays in registers (128 a thread at
// hd = 256).  Tiles are loaded with 16-byte loads, synchronously: TMA,
// a multi-stage pipeline and wgmma are later work.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
__host__ __device__ constexpr int mma_row() { return D + 8; }  // row, elements

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 3 * kBlockK * mma_row<D>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major fragment) * b (16 x 8, column fragment)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, rows) of a (rows, D) tile whose row r starts at src + r * stride
// into dst (row length mma_row<D>()); rows at or past `valid` are zeros
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int valid) {
  constexpr int kVecs = D / 8;     // 16-byte vectors of a row
  for (int idx = threadIdx.x; idx < kBlockK * kVecs; idx += kMmaThreads) {
    const int r = idx / kVecs, c = (idx - r * kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * mma_row<D>() + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int sq, int skv,
                           int heads, int kv_heads, int causal, int window,
                           float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRow = mma_row<D>();
  constexpr int kNTiles = D / 8;     // n-tiles of the output
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * kRow;
  __nv_bfloat16* vs = ks + kBlockK * kRow;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;           // the fragment's row within 8
  const int t = lane & 3;            // the fragment's column pair
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = (int)((long long)h * kv_heads / heads);
  const int q_hi = min(q_lo + kBlockQ, sq);
  const long long q_stride = (long long)heads * D;
  const long long kv_stride = (long long)kv_heads * D;
  const __nv_bfloat16* qb =
      q + ((long long)b * sq + q_lo) * q_stride + (long long)h * D;
  const __nv_bfloat16* kb =
      k + ((long long)b * skv) * kv_stride + (long long)kvh * D;
  const __nv_bfloat16* vb =
      v + ((long long)b * skv) * kv_stride + (long long)kvh * D;

  load_tile<D>(qs, qb, q_stride, q_hi - q_lo);

  float o[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q_lo + warp * 16 + g;         // rows row0 and row0 + 8

  // ldmatrix row addresses: lane supplies row (lane & 7) of matrix lane >> 3
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + (lane >> 4) * 8;
  const int kb_col = ((lane >> 3) & 1) * 8;
  const int vb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vb_col = (lane >> 4) * 8;

  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int kv_hi = causal ? min(q_hi, skv) : skv;
  for (int j0 = kv_lo; j0 < kv_hi; j0 += kBlockK) {
    __syncthreads();   // the previous tile is consumed (and qs is loaded)
    load_tile<D>(ks, kb + (long long)j0 * kv_stride, kv_stride, skv - j0);
    load_tile<D>(vs, vb + (long long)j0 * kv_stride, kv_stride, skv - j0);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + a_row * kRow + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < kBlockK / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (np * 16 + kb_row) * kRow + kk * 16 + kb_col);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row0 + (e >> 1) * 8;
        const int kpos = j0 + n * 8 + t * 2 + (e & 1);
        s[n][e] = visible(qpos, kpos, skv, causal, window)
                      ? s[n][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + vb_row) * kRow + dp * 16
                                  + vb_col);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow =
        out + ((long long)b * sq + row) * q_stride + (long long)h * D;
#pragma unroll
    for (int n = 0; n < kNTiles; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
// One block of 256 threads per (batch, head, 64-query tile); the
// online-softmax state (m, l and the 64 x hd accumulator) in registers:
// each thread owns 4 query rows, a 4 x 4 tile of the scores and a
// 4 x hd/16 tile of the output.  The query tile (scaled) and each key tile
// are staged in shared memory transposed, so that a thread reads 4
// queries and 4 keys of one head dimension as two 16-byte loads; each
// value tile and the probabilities are staged too.  hd = 256 takes 217 KB
// of shared memory, so one block runs per SM.
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kPad = kBlockQ + 4;    // row length of the transposed tiles

template <int D>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (2 * D * kPad + kBlockK * D + kBlockK * kPad) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int sq, int skv,
                           int heads, int kv_heads, int causal, int window,
                           float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                    // [D][kPad]   query tile, transposed
  float* kt = qt + D * kPad;           // [D][kPad]   key tile, transposed
  float* vs = kt + D * kPad;           // [kBlockK][D] value tile
  float* ps = vs + kBlockK * D;        // [kBlockK][kPad] probabilities

  constexpr int kCols = D / 64;        // float4 column groups of a thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = (int)((long long)h * kv_heads / heads);
  const int q_hi = min(q_lo + kBlockQ, sq);
  const long long q_stride = (long long)heads * D;
  const long long kv_stride = (long long)kv_heads * D;
  const float* qb = q + ((long long)b * sq) * q_stride + (long long)h * D;
  const float* kb = k + ((long long)b * skv) * kv_stride + (long long)kvh * D;
  const float* vb = v + ((long long)b * skv) * kv_stride + (long long)kvh * D;

  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
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
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int c = idx / D, d = idx - c * D;
      const int key = j0 + c;
      const bool in = key < skv;
      kt[d * kPad + c] = in ? kb[key * kv_stride + d] : 0.f;
      vs[c * D + d] = in ? vb[key * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
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
            *reinterpret_cast<const float4*>(&vs[c * D + gi * 64 + tx * 4]);
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
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + ((long long)b * sq + row) * q_stride + (long long)h * D;
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
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int dtype,
           int batch, int sq, int skv, int heads, int kv_heads, int causal,
           int window, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  const float scale = 1.0f / sqrtf((float)D);
  cudaError_t err;
  if (dtype == 1) {
    auto kernel = flash_attention_mma_kernel<D>;
    const int bytes = mma_smem_bytes<D>();
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), sq, skv, heads, kv_heads, causal,
        window, scale * 1.4426950408889634f);
  } else {
    auto kernel = flash_attention_f32_kernel<D>;
    const int bytes = f32_smem_bytes<D>();
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, skv,
        heads, kv_heads, causal, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16; head_dim 64, 128 or 256.  bfloat16 rows
// must start on 16 bytes (the wrapper checks the pointers).
int lotaru_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int dtype, int batch, int sq, int skv,
                           int heads, int kv_heads, int head_dim, int causal,
                           int window, cudaStream_t stream) {
  if (sq == 0 || batch == 0) return 0;
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, out, dtype, batch, sq, skv, heads, kv_heads,
                        causal, window, stream);
    case 128:
      return launch<128>(q, k, v, out, dtype, batch, sq, skv, heads,
                         kv_heads, causal, window, stream);
    case 256:
      return launch<256>(q, k, v, out, dtype, batch, sq, skv, heads,
                         kv_heads, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
