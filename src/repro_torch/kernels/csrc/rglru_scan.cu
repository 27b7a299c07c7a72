// Hand-written Hopper kernel for the RG-LRU linear recurrence of the
// Griffin (RecurrentGemma) recurrent block, built by nvcc into a plain-C
// shared library and bound with ctypes (see kernels/_build.py).
//
// Build flags: -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps each step's a*h + gx a separately rounded multiply and
// add, which is what makes the kernel bitwise equal to its plain version
// (kernels/ref.py::rglru_scan_ref).  The C entry point launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  The gradient has two routes, chosen from the width
// and the operands' addresses alone (lotaru_rglru_scan_bwd_route): `tma`,
// a TMA-fed ring of time tiles, and `direct`, a thread a channel loading
// from global memory, for widths and addresses TMA refuses.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// 64 threads a block: B*W = 8,192 channels at RecurrentGemma-9B's width
// make 128 blocks, one for each of 128 of the 132 SMs, where 256-thread
// blocks would leave 100 SMs idle.
constexpr int kThreads = 64;
constexpr int kUnroll = 32;

// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan
// (_rglru_kernel): h_t = a_t * h_{t-1} + gx_t over (B, T, W) float32, from
// h0 (B, W).
//
// Bound on the H100: memory.  Each (b, t, w) reads a and gx and writes h,
// 12 bytes, for two float32 operations.  The TPU kernel streamed the time
// axis through VMEM tiles with the carry in scratch; here one thread owns
// one (b, w) channel and walks T in order with h in a register, so nothing
// but a, gx and h touches memory.  Consecutive threads take consecutive w,
// so each step's loads and store are coalesced across a warp.  The loads
// of the next kUnroll steps are issued before the current kUnroll steps'
// dependent chain of updates runs, so a thread keeps 2 * kUnroll loads in
// flight.  The time axis stays sequential:
// only B*W threads exist, far from filling the card (a chunked two-pass
// scan is the way to more parallelism, left for later work).
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ gx,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int batch, int steps, int width) {
  const long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= (long long)batch * width) return;
  const long long b = ch / width;
  const long long w = ch - b * width;
  const long long base = b * (long long)steps * width + w;
  const float* ap = a + base;
  const float* gp = gx + base;
  float* hp = h + base;
  float hv = h0[ch];
  // chunks of kUnroll steps; the next chunk's loads are issued before the
  // current chunk's dependent chain runs
  float a_next[kUnroll], g_next[kUnroll];
  const int full = steps / kUnroll * kUnroll;
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a_next[u] = ap[(long long)u * width];
      g_next[u] = gp[(long long)u * width];
    }
  }
  for (int t = 0; t < full; t += kUnroll) {
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a_next[u];
      gv[u] = g_next[u];
    }
    if (t + kUnroll < full) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a_next[u] = ap[(long long)(t + kUnroll + u) * width];
        g_next[u] = gp[(long long)(t + kUnroll + u) * width];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = av[u] * hv + gv[u];
      hp[(long long)(t + u) * width] = hv;
    }
  }
  for (int t = full; t < steps; ++t) {
    hv = ap[(long long)t * width] * hv + gp[(long long)t * width];
    hp[(long long)t * width] = hv;
  }
}

// The scan's gradient, for training.  No TPU kernel is replaced: the JAX
// package differentiates its associative scan (repro/models/rglru.py:91);
// this computes the same gradient.  Given h (the forward's output), a, h0
// and g = dL/dh, each (b, w) channel walks t from T - 1 down:
//   dh_t = g_t + a_{t+1} dh_{t+1}   (dh_{T-1} = g_{T-1})
//   da_t = dh_t h_{t-1}  (h_{-1} = h0),   dgx_t = dh_t,   dh0 = a_0 dh_0.
// With --fmad=false each step's g + a * dh is a separately rounded
// multiply and add, so both routes are bitwise
// kernels/ref.py::rglru_scan_bwd_ref.
//
// Bound on the H100: memory (a, h and g read, da and dgx written: 20 bytes
// for three operations a step).  The time axis stays sequential (a chunked
// scan would reassociate the products of a), so only B*W threads exist:
// 4,096 at the training shape, one warp on each of 128 SMs.  What such a
// kernel can stream is the bytes it keeps in flight; Little's law wants
// about 3.35 TB/s x ~0.7 us = 2.3 MB across the card.
//
// The direct route: a thread a channel, blocks of 32.  The loads of the
// next chunk of kBwdUnroll steps (a, g and h_{t-1}) are issued before the
// current chunk's dependent chain runs: 192 bytes a thread in registers,
// about 0.8 MB in flight at the training shape.
constexpr int kBwdThreads = 32;
constexpr int kBwdUnroll = 16;

__global__ void __launch_bounds__(kBwdThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ h,
                      const float* __restrict__ h0,
                      const float* __restrict__ g, float* __restrict__ da,
                      float* __restrict__ dgx, float* __restrict__ dh0,
                      int batch, int steps, int width) {
  const long long ch = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= (long long)batch * width) return;
  const long long b = ch / width;
  const long long w = ch - b * width;
  const long long base = b * (long long)steps * width + w;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da + base;
  float* dgp = dgx + base;
  const float h_init = h0[ch];
  float dh = 0.f;
  float a_next = 0.f;                  // a_{t+1} once t < T - 1
  // the top T % kBwdUnroll steps one at a time, then whole chunks down to 0
  const int rem = steps % kBwdUnroll;
  for (int t = steps - 1; t >= steps - rem; --t) {
    const float gv = gp[(long long)t * width];
    const float hv = t > 0 ? hp[(long long)(t - 1) * width] : h_init;
    dh = t == steps - 1 ? gv : gv + a_next * dh;
    dgp[(long long)t * width] = dh;
    dap[(long long)t * width] = dh * hv;
    a_next = ap[(long long)t * width];
  }
  float a_n[kBwdUnroll], g_n[kBwdUnroll], h_n[kBwdUnroll];
  int t0 = steps - rem - kBwdUnroll;
  if (t0 >= 0) {
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      a_n[u] = ap[(long long)(t0 + u) * width];
      g_n[u] = gp[(long long)(t0 + u) * width];
      h_n[u] = t0 + u > 0 ? hp[(long long)(t0 + u - 1) * width] : h_init;
    }
  }
  for (; t0 >= 0; t0 -= kBwdUnroll) {
    float av[kBwdUnroll], gv[kBwdUnroll], hv[kBwdUnroll];
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      av[u] = a_n[u];
      gv[u] = g_n[u];
      hv[u] = h_n[u];
    }
    const int t1 = t0 - kBwdUnroll;
    if (t1 >= 0) {
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        a_n[u] = ap[(long long)(t1 + u) * width];
        g_n[u] = gp[(long long)(t1 + u) * width];
        h_n[u] = t1 + u > 0 ? hp[(long long)(t1 + u - 1) * width] : h_init;
      }
    }
#pragma unroll
    for (int u = kBwdUnroll - 1; u >= 0; --u) {
      const int t = t0 + u;
      dh = t == steps - 1 ? gv[u] : gv[u] + a_next * dh;
      dgp[(long long)t * width] = dh;
      dap[(long long)t * width] = dh * hv[u];
      a_next = av[u];
    }
  }
  dh0[ch] = a_next * dh;
}

// The tma route: a block owns kScanCols consecutive channels of one
// sequence b.  One thread of a producer warp walks the time axis from the
// top down and keeps a ring of kScanStages stages in flight, each the
// boxes of a, g and h over kScanRows steps of those channels (the h box
// one row lower, so row r of a stage holds a_t, g_t and h_{t-1});
// rows before step 0 or past T - 1 and channels past W read as zeros.
// The consumer warp, a lane a channel, reads its column of each stage
// from shared memory (a row is 32 consecutive floats: one bank a lane)
// and runs the chain above; the bytes in flight cost it no registers.
// At the training shape a block holds 72-96 KB in flight: about 10 MB
// across the card.  da and dgx of a tile are staged in one of two shared
// buffers and written by two TMA stores, which skip rows and channels
// past the tensor; the consumer waits only until the store of two tiles
// back has read its buffer.  (The warp's own 128-byte stores, two a
// step, held the kernel to half its bound.)
constexpr int kScanCols = 32;                     // channels of a block
constexpr int kScanRows = 64;                     // steps of a tile
constexpr int kScanStages = 4;                    // tiles in the ring
constexpr int kScanBox = kScanCols * kScanRows * 4;   // bytes of a box
constexpr int kScanOutBufs = 2;     // da and dgx staging, a tile each
constexpr int kRouteDirect = 0;
constexpr int kRouteTma = 1;

// the ring and the two staging buffers, 128 bytes to align the boxes and
// 128 for the mbarriers (kernels/rglru_scan.scan_bwd_smem_bytes mirrors
// it)
constexpr int scan_bwd_tma_smem_bytes() {
  return (3 * kScanStages + 2 * kScanOutBufs) * kScanBox + 128 + 128;
}

__global__ void __launch_bounds__(64)
rglru_scan_bwd_tma_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap hmap,
                          const __grid_constant__ CUtensorMap gmap,
                          const __grid_constant__ CUtensorMap damap,
                          const __grid_constant__ CUtensorMap dgmap,
                          const float* __restrict__ h0,
                          float* __restrict__ dh0, int steps, int width) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 127) & ~127u;
  const uint32_t out_s = ring + 3 * kScanStages * kScanBox;
  const uint32_t bar_full = out_s + 2 * kScanOutBufs * kScanBox;
  const uint32_t bar_empty = bar_full + 8 * kScanStages;
  const int c0 = blockIdx.x * kScanCols;
  const int b = blockIdx.y;
  const int n_tiles = (steps + kScanRows - 1) / kScanRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kScanStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 1);       // the consumer warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    // ---- the producer: tile i holds steps [i S, i S + S), top first ----
    if (threadIdx.x == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % kScanStages;
        const int t0 = (n_tiles - 1 - k) * kScanRows;
        const uint32_t dst = ring + 3 * s * kScanBox;
        mbar_wait(bar_empty + 8 * s, ((k / kScanStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 3 * kScanBox);
        tma_box3(dst, &amap, bar_full + 8 * s, c0, t0, b);
        tma_box3(dst + kScanBox, &gmap, bar_full + 8 * s, c0, t0, b);
        tma_box3(dst + 2 * kScanBox, &hmap, bar_full + 8 * s, c0, t0 - 1, b);
      }
    }
    return;
  }

  // ---- the consumer: a lane a channel ----
  const int lane = threadIdx.x - 32;
  const int c = c0 + lane;
  const bool live = c < width;
  const long long ch = (long long)b * width + c;
  // this lane's column of the ring and of the staging buffers
  float* col = reinterpret_cast<float*>(smem_raw + (ring - raw)) + lane;
  const float h_init = live ? h0[ch] : 0.f;
  float dh = 0.f;
  float a_next = 0.f;                  // a_{t+1} once t < T - 1
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kScanStages;
    const int t0 = (n_tiles - 1 - k) * kScanRows;
    const int rows = min(kScanRows, steps - t0);
    const float* as = col + 3 * s * (kScanBox / 4);
    const float* gs = as + kScanBox / 4;
    const float* hs = gs + kScanBox / 4;
    const uint32_t da_s = out_s + 2 * (k % kScanOutBufs) * kScanBox;
    float* das = col + (da_s - ring) / 4;
    float* dgs = das + kScanBox / 4;
    if (lane == 0) bulk_wait_read<kScanOutBufs - 1>();   // this buffer free
    __syncwarp();
    auto step = [&](int r) {
      const int t = t0 + r;
      const float gv = gs[r * kScanCols];
      const float hv = t > 0 ? hs[r * kScanCols] : h_init;
      dh = t == steps - 1 ? gv : gv + a_next * dh;
      dgs[r * kScanCols] = dh;
      das[r * kScanCols] = dh * hv;
      a_next = as[r * kScanCols];
    };
    mbar_wait(bar_full + 8 * s, (k / kScanStages) & 1);
    if (rows == kScanRows) {
#pragma unroll 16
      for (int r = kScanRows - 1; r >= 0; --r) step(r);
    } else {
      for (int r = rows - 1; r >= 0; --r) step(r);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    // the staged rows, written through the generic proxy, before the
    // async proxy's store reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      tma_store3(&damap, da_s, c0, t0, b);
      tma_store3(&dgmap, da_s + kScanBox, c0, t0, b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_read<0>();   // the buffers outlive the reads
  if (live) dh0[ch] = a_next * dh;
}

int scan_bwd_route(int width, int aligned) {
  return width > 0 && width % 4 == 0 && aligned ? kRouteTma : kRouteDirect;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cudaFuncSetAttribute for the tma kernel's shared memory once a device,
// not on every launch
cudaError_t tma_smem_attr(int bytes) {
  static bool set[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!set[device]) {
    err = cudaFuncSetAttribute(rglru_scan_bwd_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    set[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lotaru_rglru_scan(const float* a, const float* gx, const float* h0,
                      float* h, int batch, int steps, int width,
                      cudaStream_t stream) {
  const long long channels = (long long)batch * width;
  const int blocks = (int)((channels + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0, stream>>>(a, gx, h0, h, batch,
                                                      steps, width);
  return static_cast<int>(cudaGetLastError());
}

// The gradient's route (0 direct, 1 tma) for a width and whether the
// (B, T, W) operands a, h, g, da and dgx all start on a 16-byte boundary
// (kernels/rglru_scan.scan_bwd_route mirrors it).
int lotaru_rglru_scan_bwd_route(int width, int aligned) {
  return scan_bwd_route(width, aligned);
}

// dynamic shared memory a block of that route takes (0 on direct)
int lotaru_rglru_scan_bwd_smem_bytes(int width, int aligned) {
  return scan_bwd_route(width, aligned) == kRouteTma
             ? scan_bwd_tma_smem_bytes() : 0;
}

// the gradient on the route given: the tma route refuses
// (cudaErrorInvalidValue) a width or operand TMA cannot take
int lotaru_rglru_scan_bwd_on_route(int route, const float* a, const float* h,
                                   const float* h0, const float* g, float* da,
                                   float* dgx, float* dh0, int batch,
                                   int steps, int width,
                                   cudaStream_t stream) {
  if (route == kRouteDirect) {
    const long long channels = (long long)batch * width;
    const int blocks = (int)((channels + kBwdThreads - 1) / kBwdThreads);
    rglru_scan_bwd_kernel<<<blocks, kBwdThreads, 0, stream>>>(
        a, h, h0, g, da, dgx, dh0, batch, steps, width);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned = aligned16(a) && aligned16(h) && aligned16(g) &&
                       aligned16(da) && aligned16(dgx);
  if (route != kRouteTma || scan_bwd_route(width, aligned) != kRouteTma)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap am, hm, gm, dam, dgm;
  int rc = f32_map(&am, a, width, steps, batch, kScanCols, kScanRows);
  if (rc == 0) rc = f32_map(&hm, h, width, steps, batch, kScanCols, kScanRows);
  if (rc == 0) rc = f32_map(&gm, g, width, steps, batch, kScanCols, kScanRows);
  if (rc == 0)
    rc = f32_map(&dam, da, width, steps, batch, kScanCols, kScanRows);
  if (rc == 0)
    rc = f32_map(&dgm, dgx, width, steps, batch, kScanCols, kScanRows);
  if (rc != 0) return rc;
  const int bytes = scan_bwd_tma_smem_bytes();
  const cudaError_t err = tma_smem_attr(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kScanCols - 1) / kScanCols, batch);
  rglru_scan_bwd_tma_kernel<<<grid, 64, bytes, stream>>>(
      am, hm, gm, dam, dgm, h0, dh0, steps, width);
  return static_cast<int>(cudaGetLastError());
}

// da, dgx (B, T, W) and dh0 (B, W) float32 from a, h, g (B, T, W) and h0,
// on the route the width and the operands' addresses give.
int lotaru_rglru_scan_bwd(const float* a, const float* h, const float* h0,
                          const float* g, float* da, float* dgx, float* dh0,
                          int batch, int steps, int width,
                          cudaStream_t stream) {
  const bool aligned = aligned16(a) && aligned16(h) && aligned16(g) &&
                       aligned16(da) && aligned16(dgx);
  return lotaru_rglru_scan_bwd_on_route(scan_bwd_route(width, aligned), a, h,
                                        h0, g, da, dgx, dh0, batch, steps,
                                        width, stream);
}

}  // extern "C"
