// Hand-written Hopper kernels for causal and sliding-window attention with
// grouped (GQA/MQA) key-value heads: the prefill attention of the local
// attention blocks of RecurrentGemma (window 2048, one kv head).  Built by
// nvcc into a plain-C shared library and bound with ctypes (see
// kernels/_build.py).
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

#include <cuda.h>           // CUtensorMap and its enums (no -lcuda: the
                            // encoder is found through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // query rows of a consumer (bf16) or a
                                   // block (f32)
constexpr int kBlockK = 64;        // keys of a kv tile
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qpos, int kpos, int skv,
                                        int causal, int window) {
  bool vis = kpos < skv;
  if (causal) vis = vis && kpos <= qpos;
  if (window > 0) vis = vis && kpos > qpos - window;
  return vis;
}

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
// A consumer, per kv tile: S = Q K^T as hd / 16 wgmma m64n64k16 with both
// operands K-major in shared memory; the online softmax in base 2 on the
// accumulator fragment (row statistics over the 4 threads of a row; a tile
// wholly inside the band takes no per-element mask, see tile_kind); P
// rounded to bfloat16 in registers (as the TPU kernel casts p to v's type)
// and repacked as the A fragments of O += P V, four wgmma m64n{hd}k16 with
// V the B operand, MN-major (the transpose bit).  The 64 x hd float32
// accumulator stays in registers: 128 a thread at hd = 256.  Ping-pong
// scheduling of the two consumers and a persistent grid are later work.
constexpr int kWsThreads = 384;          // producer + two consumers
constexpr int kBoxCols = 64;             // bf16 columns of a swizzled box
constexpr int kBoxBytes = kBlockK * 128; // one 64-row box
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 40 * 128 + 232 * 256 = 64,512

// Stages of the K/V ring: two at hd = 256 (all that fits beside Q), four
// below (kernels/flash_attention.flash_stages).
__host__ __device__ constexpr int flash_stages(int d) {
  return d == 256 ? 2 : 4;
}

// Dynamic shared memory of the bf16 kernel: Q for both consumers and a ring
// of `stages` K and V tiles, each 64 rows of hd bfloat16; 1024 bytes of
// slack so that the tiles start on the 1024-byte period of the swizzle;
// 128 for the mbarriers (kernels/flash_attention.flash_smem_bytes).
__host__ __device__ constexpr int flash_smem_bytes(int d, int stages) {
  return (2 + 2 * stages) * kBlockK * d * 2 + 1024 + 128;
}

// What a consumer does with the kv tile [j0, j0 + 64) against its query
// rows [q_lo, q_hi) (kernels/flash_attention.flash_tile_kind mirrors it).
// Keys at or past skv count as hidden.
constexpr int kSkip = 0;     // every pair hidden: no work
constexpr int kFull = 1;     // every pair visible: no per-element mask
constexpr int kMasked = 2;   // the diagonal, the window edge or skv cuts it

__host__ __device__ inline int tile_kind(int q_lo, int q_hi, int j0, int skv,
                                         int causal, int window) {
  if (q_lo >= q_hi || j0 >= skv) return kSkip;
  const int j_last = (j0 + kBlockK < skv ? j0 + kBlockK : skv) - 1;
  if (causal && j0 > q_hi - 1) return kSkip;
  if (window > 0 && j_last <= q_lo - window) return kSkip;
  const bool full = j_last == j0 + kBlockK - 1 &&
                    (!causal || j_last <= q_lo) &&
                    (window <= 0 || j0 > q_hi - 1 - window);
  return full ? kFull : kMasked;
}

// The keys [*lo, *hi) the query rows [q_lo, q_hi) may see
// (kernels/flash_attention.flash_band).
__host__ __device__ inline void band(int q_lo, int q_hi, int skv, int causal,
                                     int window, int* lo, int* hi) {
  *lo = window > 0 && q_lo - window + 1 > 0 ? q_lo - window + 1 : 0;
  *hi = causal && q_hi < skv ? q_hi : skv;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// the 64 x 64 box of a 4-d map at (column, head, row, batch) into dst
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int col, int head,
                                        int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
         "r"(head), "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

// rows [row, row + 64) of one head, all D columns, as D / 64 boxes
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row,
                                         int batch) {
#pragma unroll
  for (int x = 0; x < D / kBoxCols; ++x)
    tma_box(dst + x * kBoxBytes, map, bar, x * kBoxCols, head, row, batch);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the products through wgmma ------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n"
               "wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving uses of an accumulator across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle: the start
// address, the leading and the stride byte offsets, in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) wgmma_rs_n64(o, a, b);
  else if constexpr (D == 128) wgmma_rs_n128(o, a, b);
  else wgmma_rs_n256(o, a, b);
}

// sc = Q K^T for the consumer's 64 rows and the tile's 64 keys.  Both tiles
// are K-major (hd contiguous): a k-step of 16 moves the descriptors 32 bytes
// along the swizzled 128-byte rows, and every 4 k-steps to the next box.
template <int D>
__device__ __forceinline__ void qk_product(float (&sc)[32], uint32_t qt,
                                           uint32_t kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_ss_n64(sc, smem_desc(qt + off, 16, 1024),
                 smem_desc(kt + off, 16, 1024), kk > 0);
  }
  wgmma_commit_wait();
  fence_regs(sc);
}

// o += P V: P from registers, V (64 keys x hd) MN-major; a k-step of 16
// keys moves 16 rows (2048 bytes), the next 64 columns are the next box.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&pa)[4][4],
                                           uint32_t vt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    wgmma_pv<D>(o, pa[kk], smem_desc(vt + kk * 16 * 128, kBoxBytes, 1024));
  wgmma_commit_wait();
  fence_regs(o);
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_attention_ws_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ out, int sq, int skv,
                          int heads, int kv_heads, int causal, int window,
                          float scale_log2, int pair_heads,
                          float* __restrict__ lse) {
  constexpr int kStages = flash_stages(D);
  constexpr int kTile = kBlockK * D * 2;       // bytes of a 64-row tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q of 0, 1
  const uint32_t k_s = q_s + 2 * kTile;                        // K ring
  const uint32_t v_s = k_s + kStages * kTile;                  // V ring
  const uint32_t bar_q = v_s + kStages * kTile;
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
        tma_tile<D>(q_s + c * kTile, &qmap, bar_q, head0 + c * head_step,
                    q_lo0 + c * q_step, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
        const int j0 = lo + it * kBlockK;
        tma_tile<D>(k_s + s * kTile, &kmap, bar_full + 8 * s, kvh, j0, b);
        tma_tile<D>(v_s + s * kTile, &vmap, bar_full + 8 * s, kvh, j0, b);
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
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
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
      qk_product<D>(sc, qt, k_s + s * kTile);

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
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // P as the A fragments of four k-steps of 16 keys
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
      pv_product<D>(o, pa, v_s + s * kTile);
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
        out + (((long long)b * sq + row) * heads + my_head) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(o[4 * n + 2 * r] / denom, o[4 * n + 2 * r + 1] / denom);
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
                           float scale, float* __restrict__ lse) {
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
    if (lse != nullptr && tx == 0)
      lse[((long long)b * heads + h) * sq + row] = m[i] + logf(l[i]);
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry
// point query (so the library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over a contiguous (B, S, H, hd) bfloat16 tensor as the 4-d
// (hd, H, S, B), in boxes of 64 columns of one head by 64 rows of one batch,
// with the 128-byte swizzle; rows past S read as zeros.
int bf16_map(CUtensorMap* map, const void* ptr, int d, int h, int s,
             int batch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBlockK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int batch, int sq, int skv, int heads, int kv_heads,
                int causal, int window, float* lse, cudaStream_t stream) {
  const int bytes = flash_smem_bytes(D, flash_stages(D));
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
  int rc = bf16_map(&qm, q, D, heads, sq, batch);
  if (rc == 0) rc = bf16_map(&km, skv > 0 ? k : q, D, kv_heads, rows, batch);
  if (rc == 0) rc = bf16_map(&vm, skv > 0 ? v : q, D, kv_heads, rows, batch);
  if (rc != 0) return rc;
  auto kernel = flash_attention_ws_kernel<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pair_heads = (heads / kv_heads) % 2 == 0;
  const int rows_a_block = pair_heads ? kBlockQ : 2 * kBlockQ;
  const dim3 grid((sq + rows_a_block - 1) / rows_a_block,
                  pair_heads ? heads / 2 : heads, batch);
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<grid, kWsThreads, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), sq, skv, heads,
      kv_heads, causal, window, scale * kLog2e, pair_heads, lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int batch, int sq, int skv, int heads, int kv_heads,
               int causal, int window, float* lse, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  auto kernel = flash_attention_f32_kernel<D>;
  const int bytes = f32_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv,
      heads, kv_heads, causal, window, 1.0f / sqrtf((float)D), lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int dtype,
           int batch, int sq, int skv, int heads, int kv_heads, int causal,
           int window, float* lse, cudaStream_t stream) {
  return dtype == 1
             ? launch_bf16<D>(q, k, v, out, batch, sq, skv, heads, kv_heads,
                              causal, window, lse, stream)
             : launch_f32<D>(q, k, v, out, batch, sq, skv, heads, kv_heads,
                             causal, window, lse, stream);
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 float32, 1 bfloat16; head_dim 64, 128 or 256.  bfloat16 rows
// must start on 16 bytes (the wrapper checks the pointers).  bfloat16
// asks for flash_smem_bytes of shared memory and returns
// cudaErrorInvalidValue, launching nothing, where that is above the card's
// opt-in limit.  lse, when not null, receives each row's log-sum-exp of
// its scaled scores, (batch, heads, sq) float32, for the backward; the
// serve path passes null and its launches store nothing more.
int lotaru_flash_attention(const void* q, const void* k, const void* v,
                           void* out, int dtype, int batch, int sq, int skv,
                           int heads, int kv_heads, int head_dim, int causal,
                           int window, void* lse, cudaStream_t stream) {
  float* lse_f = static_cast<float*>(lse);
  if (sq == 0 || batch == 0) return 0;
  if ((dtype != 0 && dtype != 1) || kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, out, dtype, batch, sq, skv, heads, kv_heads,
                        causal, window, lse_f, stream);
    case 128:
      return launch<128>(q, k, v, out, dtype, batch, sq, skv, heads,
                         kv_heads, causal, window, lse_f, stream);
    case 256:
      return launch<256>(q, k, v, out, dtype, batch, sq, skv, heads,
                         kv_heads, causal, window, lse_f, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the bf16 kernel's formulas, for the Python mirrors to be held against
long long lotaru_flash_smem_bytes(int head_dim, int stages) {
  return flash_smem_bytes(head_dim, stages);
}

int lotaru_flash_stages(int head_dim) { return flash_stages(head_dim); }

int lotaru_flash_tile_kind(int q_lo, int q_hi, int j0, int skv, int causal,
                           int window) {
  return tile_kind(q_lo, q_hi, j0, skv, causal, window);
}

}  // extern "C"
