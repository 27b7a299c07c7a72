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

constexpr int kThreads = 256;
constexpr int kFitIters = 30;
constexpr float kEps = 1e-9f;

// ---------------------------------------------------------------------------
// bayes_predict
// ---------------------------------------------------------------------------
// Replaces the TPU kernel repro/kernels/bayes_fit.py::bayes_predict
// (_predict_kernel): the elementwise posterior predictive, mean and std per
// query, over posterior leaves already gathered per query.
//
// Bound on the H100: memory.  Each query reads 96 bytes (x, mu[2],
// sigma[4], beta, x_mu, x_sd, y_mu, y_sd as float64) and writes 16, for
// about 20 float64 operations: far below the card's operations-per-byte
// line.  Design: one thread per query, grid-stride, so neighbouring threads
// read neighbouring elements of every leaf (coalesced).  sigma stays in its
// (Q, 2, 2) layout: the kernel reads [0,0], [0,1] and [1,1] at stride 4
// instead of the host repacking it into planes, which would cost a copy per
// call.  The TPU kernel ran float32 (the TPU has no fast float64); here
// every term is float64 and evaluated in the host reference's order
// (core.bayes.predict_blr_np, in predictive.cuh, shared with fused_cost),
// so the result is bitwise equal to it.
__global__ void __launch_bounds__(kThreads)
bayes_predict_kernel(const double* __restrict__ x,
                     const double* __restrict__ mu,
                     const double* __restrict__ sigma,
                     const double* __restrict__ beta,
                     const double* __restrict__ x_mu,
                     const double* __restrict__ x_sd,
                     const double* __restrict__ y_mu,
                     const double* __restrict__ y_sd,
                     double* __restrict__ mean,
                     double* __restrict__ std,
                     long long q) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < q;
       i += stride) {
    lotaru_predictive(x, mu, sigma, beta, x_mu, x_sd, y_mu, y_sd, i,
                      &mean[i], &std[i]);
  }
}

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

// ---------------------------------------------------------------------------
// nig_fold
// ---------------------------------------------------------------------------
// Replaces the TPU kernel repro/kernels/bayes_fit.py::nig_fold
// (_nig_fold_kernel): the masked fold of K standardized observations into
// T Normal-Inverse-Gamma states (mu, V, prec, b), one Sherman-Morrison
// rank-1 update per observation with the 2x2 algebra unrolled.
//
// Bound on the H100: memory.  Each task reads its count (4 bytes), 16
// bytes (x, y as float64) per observation it holds and its 88-byte state,
// and writes the 88-byte state back; a step is about 60 float64
// operations, three of them divides, far below the card's
// operations-per-byte line.  Design: one thread per task, grid-stride,
// with a runtime loop over the task's own count, so any K runs without the
// TPU form's column buckets and no padded cell is read.  The rows are
// prefix-masked, so a per-row count (clamped to [0, K]) replaces the TPU
// form's (T, K) mask.  The state lives in registers for the whole fold;
// the row's x and y are read at stride K (adjacent threads share cache
// lines across the loop, so each byte comes from device memory once).  The TPU kernel ran float32; here every term is
// float64 in the order of core.bayes._nig_step, with no contraction, so
// the fold is bitwise the host's float64 fold and the scalar nig_update
// chain:
//   * denom = 1 + (vp1 + x * vp2); vp1 * vp1 / denom is (vp1 * vp1) /
//     denom; the parenthesization of r1, r2, qo and qn is the host's;
//   * b is floored as numpy.maximum(nb, 1e-12), which lets a NaN through
//     (fmax would drop it);
//   * V and prec are read at [0, 0], [0, 1] and [1, 1] and written back
//     symmetric;
//   * a column past the task's count leaves the state as it is (the
//     host's where).
__global__ void __launch_bounds__(kThreads)
nig_fold_kernel(const double* __restrict__ xs, const double* __restrict__ ys,
                const int* __restrict__ counts, long long t_total, int k_cols,
                const double* __restrict__ mu, const double* __restrict__ v,
                const double* __restrict__ prec,
                const double* __restrict__ b,
                double* __restrict__ mu_out, double* __restrict__ v_out,
                double* __restrict__ prec_out, double* __restrict__ b_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < t_total; i += stride) {
    double mu1 = mu[2 * i], mu2 = mu[2 * i + 1];
    double v11 = v[4 * i], v12 = v[4 * i + 1], v22 = v[4 * i + 3];
    double p11 = prec[4 * i], p12 = prec[4 * i + 1], p22 = prec[4 * i + 3];
    double bb = b[i];
    const long long row = i * k_cols;
    const int n = min(counts[i], k_cols);
    for (int k = 0; k < n; ++k) {
      const double x = xs[row + k];
      const double y = ys[row + k];
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
    mu_out[2 * i] = mu1;
    mu_out[2 * i + 1] = mu2;
    v_out[4 * i] = v11;
    v_out[4 * i + 1] = v12;
    v_out[4 * i + 2] = v12;
    v_out[4 * i + 3] = v22;
    prec_out[4 * i] = p11;
    prec_out[4 * i + 1] = p12;
    prec_out[4 * i + 2] = p12;
    prec_out[4 * i + 3] = p22;
    b_out[i] = bb;
  }
}

}  // namespace

extern "C" {

const char* lotaru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int lotaru_bayes_predict(const double* x, const double* mu,
                         const double* sigma, const double* beta,
                         const double* x_mu, const double* x_sd,
                         const double* y_mu, const double* y_sd,
                         double* mean, double* std, long long q,
                         void* stream) {
  if (q <= 0) return 0;
  int device = 0;
  cudaGetDevice(&device);
  const int sms = sm_count(device);
  long long blocks = (q + kThreads - 1) / kThreads;
  const long long cap = 16LL * sms;  // enough resident warps to hide latency
  if (blocks > cap) blocks = cap;
  bayes_predict_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, mu, sigma, beta, x_mu, x_sd, y_mu, y_sd, mean, std, q);
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

int lotaru_nig_fold(const double* xs, const double* ys, const int* counts,
                    long long t_total, int k_cols, const double* mu,
                    const double* v, const double* prec, const double* b,
                    double* mu_out, double* v_out, double* prec_out,
                    double* b_out, void* stream) {
  if (t_total <= 0) return 0;
  int device = 0;
  cudaGetDevice(&device);
  const int sms = sm_count(device);
  long long blocks = (t_total + kThreads - 1) / kThreads;
  const long long cap = 16LL * sms;
  if (blocks > cap) blocks = cap;
  nig_fold_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      xs, ys, counts, t_total, k_cols, mu, v, prec, b, mu_out, v_out, prec_out,
      b_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
