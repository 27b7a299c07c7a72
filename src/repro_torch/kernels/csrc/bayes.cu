// Hand-written Hopper kernels for the Bayesian-linear-regression hot path
// (the paper's Section 4.5 model) and its streaming write path, built by
// nvcc into a plain-C shared library and bound with ctypes (see
// kernels/_build.py).
//
// Build flags: -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps every a*b+c as a separately rounded multiply and add,
// which is what lets bayes_predict and nig_fold match the host float64
// reference bit for bit.  Each C entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "predictive.cuh"

namespace {

constexpr int kFitIters = 30;
constexpr float kEps = 1e-9f;

// ---------------------------------------------------------------------------
// bayes_fit
// ---------------------------------------------------------------------------
// Replaces the TPU kernel repro/kernels/bayes_fit.py::bayes_fit
// (_bayes_kernel): per task, masked standardization (n = max(sum m, 1)),
// the masked Gram of [1, xs] and phi^T y, and 30 MacKay evidence
// fixed-point iterations with the closed-form 2x2 inverse and eigenvalues,
// in float32.
//
// Bound on the H100: memory, the one read of (x, y, mask) (12 bytes a
// cell).  The TPU kernel reduced a (128, N) tile on vector lanes and ran
// its scalar 2x2 algebra vectorised over the 128 tasks.  Here:
//   * One lane a task.  A block of kFitTile lanes stages its tile's rows
//     of x, y and m in shared memory, and each lane walks its own row in
//     the TPU kernel's two passes: the means, then the centred sums.
//     Lane k starts its walk at column k (mod the row's length), so at
//     N = 64 the 32 rows a warp reads at one step fall in 32 banks.
//   * The fixed point reads no memory.  Its residual
//     sum (ys - (mu1 + mu2 xs) m)^2 is a quadratic form in (mu1, mu2), so
//     the second pass also accumulates six float64 moments (sum ys^2,
//     m ys, m xs ys, m^2, m^2 xs, m^2 xs^2; a product of two float32
//     values is exact in float64, so the form does not cancel), and the
//     30 iterations run on a handful of registers: no loads, shuffles or
//     barriers.  The Gram, phi^T y and moments are summed over the centred
//     row and scaled by 1/sd afterwards, so the row is read twice, not
//     three times.  The mask enters in general form, so fractional masks
//     fit as the TPU kernel fits them.  The fixed point's divides are MUFU
//     reciprocals (__fdividef, one reciprocal of det for the 2x2
//     inverse): an IEEE divide is a long instruction sequence with a
//     slow-path branch, and the fit is held at rtol 5e-3, not bitwise.
//   * The copy does not hold the lanes.  Where a tile's rows are one
//     contiguous, 16-byte aligned range (N <= kFitChunk, the fleet's case),
//     one thread issues a bulk copy an array (cp.async.bulk, completion on
//     an mbarrier) and goes on to its own work; a copy per lane would
//     stall every warp until the data were in.  Other shapes take 4-byte
//     cp.async copies from every lane: rows longer than kFitChunk columns
//     are staged a chunk at a time, once for each pass.
//   * One shared-memory tile a block, two blocks an SM at N = 64 (98,320
//     bytes each), and a grid of as many blocks as fit on the card at
//     once, each walking tiles: a block's next tile is copied under this
//     tile's fixed point and under the other block's work.
//   * Rows past T are neither copied nor written; a fully masked row fits
//     the same finite default as the TPU kernel.  The file builds with
//     --fmad=false; the fit's sums use fmaf/fma where a fused multiply-add
//     serves them.
constexpr int kFitTile = 128;   // tasks (lanes) a block
constexpr int kFitChunk = 64;   // columns staged a row and array
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 4-byte global -> shared copy, complete after cp_async_wait_all
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// the row stride of a staged plane (columns a staged row)
__host__ __device__ __forceinline__ int fit_stride(int n_cols) {
  return n_cols < kFitChunk ? n_cols : kFitChunk;
}

__host__ __device__ __forceinline__ int fit_smem_bytes(int n_cols) {
  return 3 * kFitTile * fit_stride(n_cols) * (int)sizeof(float) + 16;
}

// One thread: the tile's rows [row0, row0 + rows) of x, y and m, all
// n_cols <= kFitChunk columns, into the three planes of buf, as one bulk
// copy a array (16-byte multiples; at most 3 floats an array left over,
// copied by hand), completing on the mbarrier `bar`.
__device__ void fit_stage_bulk(const float* x, const float* y,
                               const float* m, float* buf, uint32_t bar,
                               long long row0, int rows, int n_cols) {
  const int plane = kFitTile * n_cols;
  const long long base = row0 * n_cols;
  const int count = rows * n_cols, bulk = count & ~3;
  for (int e = bulk; e < count; ++e) {
    buf[e] = x[base + e];
    buf[plane + e] = y[base + e];
    buf[2 * plane + e] = m[base + e];
  }
  // the lanes' reads of the last tile are ordered before these writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(3 * bulk * (int)sizeof(float)) : "memory");
  if (bulk == 0) return;
  const float* src[3] = {x + base, y + base, m + base};
  for (int a = 0; a < 3; ++a)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(buf + a * plane)), "l"(src[a]),
          "r"(bulk * (int)sizeof(float)), "r"(bar)
        : "memory");
}

// Every thread: columns [c0, c0 + cw) of the tile's rows into the three
// planes of buf (rows at `stride`), 4-byte cp.async copies.  Thread i
// takes elements i, i + kFitTile, ... of the row-major (rows, cw) box, so
// neighbouring lanes read neighbouring words of device memory.
__device__ void fit_stage_cp(const float* __restrict__ x,
                             const float* __restrict__ y,
                             const float* __restrict__ m, float* buf,
                             long long row0, int rows, int n_cols, int c0,
                             int cw, int stride) {
  if (cw <= 0) return;
  const int plane = kFitTile * stride;
  const int dr = kFitTile / cw, dj = kFitTile - dr * cw;
  int r = threadIdx.x / cw, j = threadIdx.x - r * cw;
  for (int e = threadIdx.x; e < rows * cw; e += kFitTile) {
    const long long g = (row0 + r) * n_cols + c0 + j;
    float* s = buf + r * stride + j;
    cp_async4(s, x + g);
    cp_async4(s + plane, y + g);
    cp_async4(s + 2 * plane, m + g);
    r += dr;
    j += dj;
    if (j >= cw) {
      j -= cw;
      ++r;
    }
  }
}

// kBulk: every row of a tile staged at once by fit_stage_bulk (n_cols <=
// kFitChunk, aligned operands); otherwise fit_stage_cp, a chunk at a time.
template <bool kBulk>
__global__ void __launch_bounds__(kFitTile)
bayes_fit_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ m, int t_total, int n_cols,
                 float* __restrict__ mu_out, float* __restrict__ sigma_out,
                 float* __restrict__ alpha_out, float* __restrict__ beta_out,
                 float* __restrict__ x_mu_out, float* __restrict__ x_sd_out,
                 float* __restrict__ y_mu_out, float* __restrict__ y_sd_out,
                 float* __restrict__ n_out) {
  extern __shared__ __align__(16) float fit_buf[];
  const int stride = fit_stride(n_cols);
  const int plane = kFitTile * stride;
  const int n_chunks = (n_cols + kFitChunk - 1) / kFitChunk;
  const int n_tiles = (t_total + kFitTile - 1) / kFitTile;
  const float* xr = fit_buf + threadIdx.x * stride;
  const float* yr = xr + plane;
  const float* mr = xr + 2 * plane;
  const uint32_t bar = smem_u32(fit_buf + 3 * plane);
  const auto rows_of = [&](int tile) {
    return min(kFitTile, t_total - tile * kFitTile);
  };
  const auto stage_first = [&](int tile) {
    if (kBulk) {
      if (threadIdx.x == 0)
        fit_stage_bulk(x, y, m, fit_buf, bar, (long long)tile * kFitTile,
                       rows_of(tile), n_cols);
    } else {
      fit_stage_cp(x, y, m, fit_buf, (long long)tile * kFitTile,
                   rows_of(tile), n_cols, 0, min(n_cols, kFitChunk), stride);
    }
  };

  if (kBulk && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int tile = blockIdx.x;
  if (tile < n_tiles) stage_first(tile);
  for (uint32_t parity = 0; tile < n_tiles;
       tile += gridDim.x, parity ^= 1) {
    const long long row0 = (long long)tile * kFitTile;
    const int rows = rows_of(tile);
    const bool live = (int)threadIdx.x < rows;
    // One pass over the row.  Chunk 0 of the first pass was staged ahead;
    // a row of one chunk stays staged for the second pass, a longer row is
    // staged again chunk by chunk.
    const auto walk = [&](bool first, auto&& body) {
      for (int c = 0; c < n_chunks; ++c) {
        const int c0 = c * kFitChunk, cw = min(kFitChunk, n_cols - c0);
        if (n_chunks > 1 && !(first && c == 0))
          fit_stage_cp(x, y, m, fit_buf, row0, rows, n_cols, c0, cw,
                       stride);
        if (first || n_chunks > 1) {
          if (kBulk) {
            mbar_wait(bar, parity);
          } else {
            cp_async_wait_all();
            __syncthreads();
          }
        }
        if (live) {
          int j = threadIdx.x % cw;
          for (int k = 0; k < cw; ++k) {
            body(xr[j], yr[j], mr[j]);
            j = j + 1 == cw ? 0 : j + 1;
          }
        }
        if (n_chunks > 1) __syncthreads();
      }
    };

    float sm = 0.f, sx = 0.f, sy = 0.f;
    walk(true, [&](float xj, float yj, float mj) {
      sm += mj;
      sx = fmaf(xj, mj, sx);
      sy = fmaf(yj, mj, sy);
    });
    const float g11 = sm;
    const float n = fmaxf(sm, 1.0f);
    const float x_mu = sx / n, y_mu = sy / n;

    // centred: dx = x - x_mu; dxm = dx m, dym = dy m (xs = dxm / x_sd)
    float vx = 0.f, vy = 0.f, sdx = 0.f, sdxx = 0.f, sdy = 0.f, sdxy = 0.f;
    double syy = 0.0, smy = 0.0, smxy = 0.0, smm = 0.0, smmx = 0.0,
           smmxx = 0.0;
    walk(false, [&](float xj, float yj, float mj) {
      const float dx = xj - x_mu, dy = yj - y_mu;
      vx = fmaf(dx * dx, mj, vx);
      vy = fmaf(dy * dy, mj, vy);
      const float dxm = dx * mj, dym = dy * mj;
      sdx += dxm;
      sdxx = fmaf(dxm, dxm, sdxx);
      sdy += dym;
      sdxy = fmaf(dxm, dym, sdxy);
      const double md = mj, xd = dxm, yd = dym;
      const double mx = md * xd;           // exact
      const double mmx = mx * md;
      syy = fma(yd, yd, syy);
      smy = fma(md, yd, smy);
      smxy = fma(mx, yd, smxy);
      smm = fma(md, md, smm);
      smmx += mmx;
      smmxx = fma(mmx, xd, smmxx);
    });
    // every lane has read the tile: stage the block's next one under the
    // fixed point
    if (n_chunks == 1) __syncthreads();
    if (tile + (int)gridDim.x < n_tiles) stage_first(tile + gridDim.x);
    if (!live) continue;

    const float x_sd = sqrtf(vx / n + kEps), y_sd = sqrtf(vy / n + kEps);
    const float rx = 1.0f / x_sd, ry = 1.0f / y_sd;
    const float g12 = sdx * rx, g22 = sdxx * rx * rx;
    const float p1 = sdy * ry, p2 = sdxy * rx * ry;
    const double rxd = rx, ryd = ry;
    syy *= ryd * ryd;
    smy *= ryd;
    smxy *= rxd * ryd;
    smmx *= rxd;
    smmxx *= rxd * rxd;

    const double c_my = -2.0 * smy, c_mxy = -2.0 * smxy;
    float alpha = 1.0f, beta = 1.0f;
    for (int it = 0; it < kFitIters; ++it) {
      const float a11 = alpha + beta * g11;
      const float a12 = beta * g12;
      const float a22 = alpha + beta * g22;
      const float det = fmaxf(a11 * a22 - a12 * a12, 1e-30f);
      const float rdet = __fdividef(1.0f, det);
      const float i11 = a22 * rdet, i12 = -a12 * rdet, i22 = a11 * rdet;
      const float mu1 = beta * (i11 * p1 + i12 * p2);
      const float mu2 = beta * (i12 * p1 + i22 * p2);
      // eigenvalues of beta * Gram, closed form
      const float b11 = beta * g11, b12 = beta * g12, b22 = beta * g22;
      const float tr = b11 + b22;
      const float bdet = b11 * b22 - b12 * b12;
      const float disc = sqrtf(fmaxf(tr * tr / 4.0f - bdet, 0.0f));
      const float l1 = tr / 2.0f - disc, l2 = tr / 2.0f + disc;
      const float gamma =
          __fdividef(l1, alpha + l1) + __fdividef(l2, alpha + l2);
      // the residual from the moments:
      // syy + mu1 (mu1 smm + 2 mu2 smmx - 2 smy) + mu2 (mu2 smmxx - 2 smxy)
      const double m1 = mu1, m2 = mu2;
      const double u = fma(m1, smm, fma(2.0 * m2, smmx, c_my));
      const double v = fma(m2, smmxx, c_mxy);
      const float resid = (float)fma(m1, u, fma(m2, v, syy));
      alpha = __fdividef(gamma, fmaxf(mu1 * mu1 + mu2 * mu2, kEps));
      beta = __fdividef(fmaxf(n - gamma, kEps), fmaxf(resid, kEps));
      alpha = fminf(fmaxf(alpha, 1e-6f), 1e6f);
      beta = fminf(fmaxf(beta, 1e-6f), 1e8f);
    }

    const float a11 = alpha + beta * g11;
    const float a12 = beta * g12;
    const float a22 = alpha + beta * g22;
    const float det = fmaxf(a11 * a22 - a12 * a12, 1e-30f);
    const float rdet = __fdividef(1.0f, det);
    const float i11 = a22 * rdet, i12 = -a12 * rdet, i22 = a11 * rdet;
    const long long task = row0 + threadIdx.x;
    reinterpret_cast<float2*>(mu_out)[task] =
        make_float2(beta * (i11 * p1 + i12 * p2),
                    beta * (i12 * p1 + i22 * p2));
    reinterpret_cast<float4*>(sigma_out)[task] =
        make_float4(i11, i12, i12, i22);
    alpha_out[task] = alpha;
    beta_out[task] = beta;
    x_mu_out[task] = x_mu;
    x_sd_out[task] = x_sd;
    y_mu_out[task] = y_mu;
    y_sd_out[task] = y_sd;
    n_out[task] = n;
  }
}

// The card's SM count, read once per device.
int sm_count(int device) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 132;
  if (cached[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms > 0 ? sms : 132;
  }
  return cached[device];
}

// The fit's route (1 bulk, 0 cp.async) for these operands.
int fit_route(const void* x, const void* y, const void* m, int n_cols) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(x) |
                                  reinterpret_cast<unsigned long long>(y) |
                                  reinterpret_cast<unsigned long long>(m);
  return n_cols > 0 && n_cols <= kFitChunk && (bits & 15) == 0;
}

// The fit's launch shape on `route` for n_cols: dynamic shared memory a
// block and blocks an SM (set up once per device, route and stride).
cudaError_t fit_config(int route, int n_cols, int* smem_bytes,
                       int* blocks_per_sm) {
  static int cached[kMaxDevices][2][kFitChunk + 1];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  *smem_bytes = fit_smem_bytes(n_cols);
  int& slot = cached[device][route][fit_stride(n_cols)];
  if (slot == 0) {
    const void* fn = route ? (const void*)bayes_fit_kernel<true>
                           : (const void*)bayes_fit_kernel<false>;
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fit_smem_bytes(kFitChunk));
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                        kFitTile,
                                                        *smem_bytes);
    if (err != cudaSuccess) return err;
    slot = blocks > 0 ? blocks : 1;
  }
  *blocks_per_sm = slot;
  return cudaSuccess;
}

// The fit's launch shape: its route, blocks in the grid (as many as fit,
// capped at the tiles), dynamic shared memory a block, blocks an SM and
// column chunks a row.
struct FitShape {
  int route, grid, smem_bytes, blocks_per_sm, chunks;
};

cudaError_t fit_shape(const void* x, const void* y, const void* m,
                      int t_total, int n_cols, FitShape* shape) {
  shape->route = fit_route(x, y, m, n_cols);
  cudaError_t err = fit_config(shape->route, n_cols, &shape->smem_bytes,
                               &shape->blocks_per_sm);
  if (err != cudaSuccess) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const long long tiles = ((long long)t_total + kFitTile - 1) / kFitTile;
  const long long blocks = (long long)shape->blocks_per_sm * sm_count(device);
  shape->grid = (int)(blocks < tiles ? blocks : tiles);
  shape->chunks = (n_cols + kFitChunk - 1) / kFitChunk;
  return cudaSuccess;
}

// One thread: arm the block's mbarrier `bar` (count 1) for `bytes` bytes
// and bulk-copy them from global `src` into shared `dst` (cp.async.bulk:
// 16-byte aligned ends, a 16-byte multiple, completion on the mbarrier).
// The caller's __syncthreads() after it makes the initialised barrier
// visible to the lanes that wait on it.
__device__ __forceinline__ void bulk_stage(void* dst, const void* src,
                                           int bytes, uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// bayes_predict
// ---------------------------------------------------------------------------
// Replaces the TPU kernel repro/kernels/bayes_fit.py::bayes_predict
// (_predict_kernel): the elementwise posterior predictive, mean and std per
// query, over posterior rows already gathered per query.
//
// What binds it on the H100 is the launch, not the bytes.  A query needs
// 88 bytes and writes 16 for about 20 float64 operations, so the body is
// memory-bound, and the per-leaf kernel before this one already streamed
// at 96 % of the card's rate; but nearly every main-path launch carries
// at most a few thousand queries, where the 5.6 us between two events
// around a launch is most of the kernel's time, and a caller paid more
// again around it: ten operands copied up one array at a time from
// pageable memory and, on the resident plane, two index copies a plane to
// scatter the results.  So the design works on what a launch costs the
// caller:
//   * One packed slab in, in column groups (kernels.bayes_fit.pack_predict):
//     for q queries and p = q rounded up to even, x at slot 0, mu (q, 2) at
//     p, sigma (q, 2, 2) at 3p, beta_prec, x_mu, x_sd, y_mu and y_sd at 7p
//     to 11p, the destination index (int64) at 12p; every group starts on
//     a 16-byte boundary.  The host fills each group with one contiguous
//     copy, or the store's gather writes straight into it, in pinned
//     memory, and the slab goes up in one asynchronous copy.  Rows of
//     interleaved values would cost the host a second, strided pass over
//     the bytes, which at 100,000 queries took longer than the ten copies
//     it replaced.
//   * A lane a query reads its values from the groups, each load coalesced
//     across the warp (mu and sigma[0, 0:2] as 16-byte loads).
//   * Results where the caller keeps them.  With no target table, mean and
//     std interleaved, (Q, 2), one 16-byte store a lane and one copy down.
//     With one, the slab carries after its groups a table of PredictTarget
//     (first query, mean and std pointers, length) a resident plane, and a
//     lane writes its mean and std at its destination index in its plane's
//     rows (the plane found by a binary search over the first queries): the
//     scatter is the kernel's store, and no index copy follows.  A
//     destination outside the plane's rows is not written.
// The terms are float64 in the host reference's order
// (core.bayes.predict_blr_np, in predictive.cuh, shared with fused_cost),
// with --fmad=false and IEEE sqrt, so the result is bitwise equal to it.
// The slab's layout and the row's reads are predictive.cuh's
// (lotaru_slab_predictive), shared with fused_cost.
constexpr int kPredictTile = 256;   // queries (lanes) a block

struct PredictTarget {
  long long first;                  // the plane's first query in the slab
  double* mean;                     // its resident rows
  double* std;
  long long n;                      // their length
};
static_assert(sizeof(PredictTarget) == 32, "the target table's row");

__global__ void __launch_bounds__(kPredictTile)
bayes_predict_kernel(const double* __restrict__ slab, long long q,
                     long long p, const PredictTarget* __restrict__ targets,
                     int n_targets, double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kPredictTile + threadIdx.x;
  if (i >= q) return;
  double mean, std;
  lotaru_slab_predictive(slab, p, i, &mean, &std);
  if (n_targets == 0) {
    reinterpret_cast<double2*>(out)[i] = make_double2(mean, std);
    return;
  }
  int lo = 0, hi = n_targets - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (targets[mid].first <= i) lo = mid; else hi = mid - 1;
  }
  const PredictTarget& t = targets[lo];
  const long long dst = reinterpret_cast<const long long*>(slab + 12 * p)[i];
  if (dst >= 0 && dst < t.n) {
    t.mean[dst] = mean;
    t.std[dst] = std;
  }
}

// ---------------------------------------------------------------------------
// nig_fold
// ---------------------------------------------------------------------------
// Replaces the TPU kernel repro/kernels/bayes_fit.py::nig_fold
// (_nig_fold_kernel): the masked fold of standardized observations into T
// Normal-Inverse-Gamma states (mu, V, prec, b), one Sherman-Morrison
// rank-1 update per observation with the 2x2 algebra unrolled.
//
// What binds it on the H100 is the launch, not the bytes: the fleet fold
// (65,536 tasks, ~295,000 observations) moves about 15 MB, 4.5 us at the
// card's rate, beside the 5.6 us a launch costs; the write path's usual
// launch is a small observe_many group, all floor.  The kernel before
// this one read (T, K) padded observations at a stride of K x 8 bytes and
// its state at strides of 16 and 32 bytes, about 1.9x the bytes it needs,
// and a caller paid seven copies up and four down around it.  So:
//   * One ragged slab in (core.bayes.fold_pack).  Its head holds the T + 1
//     row offsets (int64, in float64 slots from the slab's start, padded
//     to an even count); row i holds a 10-slot header (its count, mu[0],
//     mu[1], V at [0,0], [0,1], [1,1], prec at the same three, b), then its
//     count standardized (x, y) pairs, with no padding column.  A row is
//     an even number of slots, so every row starts on a 16-byte boundary.
//   * A block takes a tile of kFoldTile rows and stages the first
//     kFoldStage slots of their byte range with one bulk copy
//     (cp.async.bulk on an mbarrier) while its lanes read their row
//     bounds.  A lane whose row lies wholly inside the staged part folds
//     it from shared memory; a row that ends past it (a tile whose rows
//     are longer than the block's budget) is walked from global memory by
//     its lane.  At the fleet's rows (at most 26 slots) a tile's range is
//     at most 3,328 slots and is staged whole.
//   * One lane a row, the state in registers for the whole fold, then one
//     state slab out, (T, 9): mu (2), V and prec at [0,0], [0,1], [1,1],
//     and b, put in shared memory and written by the block in coalesced
//     stores, copied down once.
// Every term is float64 in the order of core.bayes._nig_step, with no
// contraction, so the fold is bitwise the host's float64 fold and the
// scalar nig_update chain:
//   * denom = 1 + (vp1 + x * vp2); vp1 * vp1 / denom is (vp1 * vp1) /
//     denom; the parenthesization of r1, r2, qo and qn is the host's;
//   * b is floored as numpy.maximum(nb, 1e-12), which lets a NaN through
//     (fmax would drop it);
//   * a row with no observation leaves its state as it is.
constexpr int kFoldTile = 128;      // rows (lanes) a block
constexpr int kFoldHead = 10;       // header slots a row
constexpr int kFoldState = 9;       // state slots a row out
constexpr int kFoldStage = 4608;    // slab slots staged a block (36 KB)

__global__ void __launch_bounds__(kFoldTile)
nig_fold_kernel(const double* __restrict__ slab, long long t_total,
                double* __restrict__ out) {
  __shared__ __align__(16) double stage[kFoldStage];
  __shared__ __align__(16) double state[kFoldTile * kFoldState];
  __shared__ __align__(8) unsigned long long bar_word;
  const long long* off = reinterpret_cast<const long long*>(slab);
  const long long row0 = (long long)blockIdx.x * kFoldTile;
  const int rows = (int)min((long long)kFoldTile, t_total - row0);
  const long long s0 = off[row0];
  const long long staged = min(off[row0 + rows] - s0, (long long)kFoldStage);
  const uint32_t bar = smem_u32(&bar_word);
  if (threadIdx.x == 0)
    bulk_stage(stage, slab + s0, (int)staged * (int)sizeof(double), bar);
  const bool live = (int)threadIdx.x < rows;
  long long a = 0, e = 0;
  if (live) {
    a = off[row0 + threadIdx.x];
    e = off[row0 + threadIdx.x + 1];
  }
  __syncthreads();
  mbar_wait(bar, 0);
  if (live) {
    const double* r = (e - s0 <= staged) ? stage + (a - s0) : slab + a;
    const int n = (int)min((long long)r[0], (e - a - kFoldHead) / 2);
    double mu1 = r[1], mu2 = r[2];
    double v11 = r[3], v12 = r[4], v22 = r[5];
    double p11 = r[6], p12 = r[7], p22 = r[8];
    double bb = r[9];
    for (int k = 0; k < n; ++k) {
      const double x = r[kFoldHead + 2 * k];
      const double y = r[kFoldHead + 2 * k + 1];
      const double vp1 = v11 + v12 * x;
      const double vp2 = v12 + v22 * x;
      const double denom = 1.0 + (vp1 + x * vp2);
      const double nv11 = v11 - vp1 * vp1 / denom;
      const double nv12 = v12 - vp1 * vp2 / denom;
      const double nv22 = v22 - vp2 * vp2 / denom;
      const double np11 = p11 + 1.0;
      const double np12 = p12 + x;
      const double np22 = p22 + x * x;
      const double r1 = (p11 * mu1 + p12 * mu2) + y;
      const double r2 = (p12 * mu1 + p22 * mu2) + x * y;
      const double nmu1 = nv11 * r1 + nv12 * r2;
      const double nmu2 = nv12 * r1 + nv22 * r2;
      const double qo = (mu1 * p11 + mu2 * p12) * mu1
                        + (mu1 * p12 + mu2 * p22) * mu2;
      const double qn = (nmu1 * np11 + nmu2 * np12) * nmu1
                        + (nmu1 * np12 + nmu2 * np22) * nmu2;
      const double nb = bb + 0.5 * (y * y + qo - qn);
      mu1 = nmu1;
      mu2 = nmu2;
      v11 = nv11;
      v12 = nv12;
      v22 = nv22;
      p11 = np11;
      p12 = np12;
      p22 = np22;
      bb = (nb < 1e-12) ? 1e-12 : nb;
    }
    double* s = state + threadIdx.x * kFoldState;
    s[0] = mu1;
    s[1] = mu2;
    s[2] = v11;
    s[3] = v12;
    s[4] = v22;
    s[5] = p11;
    s[6] = p12;
    s[7] = p22;
    s[8] = bb;
  }
  __syncthreads();
  double* o = out + row0 * kFoldState;
  for (int j = threadIdx.x; j < rows * kFoldState; j += kFoldTile)
    o[j] = state[j];
}

// ---------------------------------------------------------------------------
// the launch floor probe
// ---------------------------------------------------------------------------
// Replaces no TPU kernel.  An empty kernel, timed as the others are, says
// how much of the ~5.6 us between two events around a short launch is the
// launch itself and how much the kernels' own latency (a load, a barrier,
// a store).  It is not on any path and counts no launches.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The predictive over the packed slab (kernels.bayes_fit.pack_predict): q
// queries in column groups of p = q rounded up to even slots, the slab
// 16-byte aligned; with n_targets > 0 the slab holds after its groups (at
// slot kQuerySlots * p) that many PredictTarget rows (first queries
// ascending from 0) and the results are scattered into them, out is not
// read; else out is (q, 2), mean and std interleaved.
int lotaru_bayes_predict(const double* slab, long long q, int n_targets,
                         double* out, void* stream) {
  if (q <= 0) return 0;
  const long long p = q + (q & 1);
  const long long blocks = (q + kPredictTile - 1) / kPredictTile;
  const PredictTarget* targets =
      n_targets > 0
          ? reinterpret_cast<const PredictTarget*>(slab + kQuerySlots * p)
          : nullptr;
  bayes_predict_kernel<<<(unsigned)blocks, kPredictTile, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      slab, q, p, targets, n_targets, out);
  return static_cast<int>(cudaGetLastError());
}

int lotaru_bayes_fit(const float* x, const float* y, const float* m,
                     int t_total, int n_cols, float* mu, float* sigma,
                     float* alpha, float* beta, float* x_mu, float* x_sd,
                     float* y_mu, float* y_sd, float* n, void* stream) {
  if (t_total <= 0) return 0;
  FitShape shape;
  const cudaError_t err = fit_shape(x, y, m, t_total, n_cols, &shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel =
      shape.route ? bayes_fit_kernel<true> : bayes_fit_kernel<false>;
  kernel<<<(unsigned)shape.grid, kFitTile, shape.smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      x, y, m, t_total, n_cols, mu, sigma, alpha, beta, x_mu, x_sd, y_mu,
      y_sd, n);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape lotaru_bayes_fit takes at (t_total, n_cols) for
// operands at x, y, m (fit_shape).  Returns a CUDA error code.
int lotaru_bayes_fit_config(const float* x, const float* y, const float* m,
                            int t_total, int n_cols, int* route, int* grid,
                            int* smem_bytes, int* blocks_per_sm,
                            int* chunks) {
  FitShape shape;
  const cudaError_t err = fit_shape(x, y, m, t_total, n_cols, &shape);
  if (err != cudaSuccess) return static_cast<int>(err);
  *route = shape.route;
  *grid = shape.grid;
  *smem_bytes = shape.smem_bytes;
  *blocks_per_sm = shape.blocks_per_sm;
  *chunks = shape.chunks;
  return 0;
}

// The fold of the ragged slab (core.bayes.fold_pack) of t_total rows,
// 16-byte aligned, into out, (t_total, 9) float64.
int lotaru_nig_fold(const double* slab, long long t_total, double* out,
                    void* stream) {
  if (t_total <= 0) return 0;
  const long long blocks = (t_total + kFoldTile - 1) / kFoldTile;
  nig_fold_kernel<<<(unsigned)blocks, kFoldTile, 0,
                    static_cast<cudaStream_t>(stream)>>>(slab, t_total, out);
  return static_cast<int>(cudaGetLastError());
}

// The fold's tile: rows a block and float64 slots it stages.
void lotaru_nig_fold_shape(int* tile_rows, int* stage_slots) {
  *tile_rows = kFoldTile;
  *stage_slots = kFoldStage;
}

// The launch floor probe: one empty launch of blocks x threads.
int lotaru_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
