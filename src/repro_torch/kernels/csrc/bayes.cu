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

#include "predictive.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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
// (_bayes_kernel): per task, masked standardization, the 2x2 Gram of the
// [1, x] design, and 30 MacKay evidence fixed-point iterations with the
// closed-form 2x2 inverse and eigenvalues, in float32.
//
// Bound on the H100: memory for the one pass over (x, y, mask); the
// fixed point repeats a residual over the row 30 times, which the L1 cache
// serves.  Design: one warp per task.  The TPU kernel reduced a
// (block_tasks, N) tile along lanes; here the 32 lanes of a warp stride the
// N columns of one row (coalesced loads) and butterfly shuffles reduce the
// masked sums and each iteration's residual, leaving the same value in
// every lane, so all lanes run the scalar 2x2 algebra in lockstep and
// lane 0 writes the posterior.  Padded columns and rows carry mask 0 and
// drop out of every sum (n = max(sum m, 1)); a row past T is never read.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
bayes_fit_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ m, int t_total, int n_cols,
                 float* __restrict__ mu_out, float* __restrict__ sigma_out,
                 float* __restrict__ alpha_out, float* __restrict__ beta_out,
                 float* __restrict__ x_mu_out, float* __restrict__ x_sd_out,
                 float* __restrict__ y_mu_out, float* __restrict__ y_sd_out,
                 float* __restrict__ n_out) {
  const int lane = threadIdx.x & 31;
  const long long task = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= t_total) return;  // whole warp leaves together
  const float* xr = x + task * n_cols;
  const float* yr = y + task * n_cols;
  const float* mr = m + task * n_cols;

  float sm = 0.f, sx = 0.f, sy = 0.f;
  for (int j = lane; j < n_cols; j += 32) {
    const float mj = mr[j];
    sm += mj;
    sx += xr[j] * mj;
    sy += yr[j] * mj;
  }
  const float g11 = warp_sum(sm);
  const float n = fmaxf(g11, 1.0f);
  const float x_mu = warp_sum(sx) / n;
  const float y_mu = warp_sum(sy) / n;

  float vx = 0.f, vy = 0.f;
  for (int j = lane; j < n_cols; j += 32) {
    const float mj = mr[j];
    const float dx = xr[j] - x_mu;
    const float dy = yr[j] - y_mu;
    vx += dx * dx * mj;
    vy += dy * dy * mj;
  }
  const float x_sd = sqrtf(warp_sum(vx) / n + kEps);
  const float y_sd = sqrtf(warp_sum(vy) / n + kEps);

  float s12 = 0.f, s22 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < n_cols; j += 32) {
    const float mj = mr[j];
    const float xs = (xr[j] - x_mu) / x_sd * mj;
    const float ys = (yr[j] - y_mu) / y_sd * mj;
    s12 += xs;
    s22 += xs * xs;
    s1 += ys;
    s2 += xs * ys;
  }
  const float g12 = warp_sum(s12);
  const float g22 = warp_sum(s22);
  const float p1 = warp_sum(s1);
  const float p2 = warp_sum(s2);

  float alpha = 1.0f, beta = 1.0f;
  for (int it = 0; it < kFitIters; ++it) {
    const float a11 = alpha + beta * g11;
    const float a12 = beta * g12;
    const float a22 = alpha + beta * g22;
    const float det = fmaxf(a11 * a22 - a12 * a12, 1e-30f);
    const float i11 = a22 / det, i12 = -a12 / det, i22 = a11 / det;
    const float mu1 = beta * (i11 * p1 + i12 * p2);
    const float mu2 = beta * (i12 * p1 + i22 * p2);
    // eigenvalues of beta * Gram, closed form
    const float b11 = beta * g11, b12 = beta * g12, b22 = beta * g22;
    const float tr = b11 + b22;
    const float bdet = b11 * b22 - b12 * b12;
    const float disc = sqrtf(fmaxf(tr * tr / 4.0f - bdet, 0.0f));
    const float l1 = tr / 2.0f - disc, l2 = tr / 2.0f + disc;
    const float gamma = l1 / (alpha + l1) + l2 / (alpha + l2);
    float r = 0.f;
    for (int j = lane; j < n_cols; j += 32) {
      const float mj = mr[j];
      const float xs = (xr[j] - x_mu) / x_sd * mj;
      const float ys = (yr[j] - y_mu) / y_sd * mj;
      const float e = ys - (mu1 + mu2 * xs) * mj;
      r += e * e;
    }
    const float resid = warp_sum(r);
    alpha = gamma / fmaxf(mu1 * mu1 + mu2 * mu2, kEps);
    beta = fmaxf(n - gamma, kEps) / fmaxf(resid, kEps);
    alpha = fminf(fmaxf(alpha, 1e-6f), 1e6f);
    beta = fminf(fmaxf(beta, 1e-6f), 1e8f);
  }

  const float a11 = alpha + beta * g11;
  const float a12 = beta * g12;
  const float a22 = alpha + beta * g22;
  const float det = fmaxf(a11 * a22 - a12 * a12, 1e-30f);
  const float i11 = a22 / det, i12 = -a12 / det, i22 = a11 / det;
  if (lane == 0) {
    mu_out[2 * task] = beta * (i11 * p1 + i12 * p2);
    mu_out[2 * task + 1] = beta * (i12 * p1 + i22 * p2);
    sigma_out[4 * task] = i11;
    sigma_out[4 * task + 1] = i12;
    sigma_out[4 * task + 2] = i12;
    sigma_out[4 * task + 3] = i22;
    alpha_out[task] = alpha;
    beta_out[task] = beta;
    x_mu_out[task] = x_mu;
    x_sd_out[task] = x_sd;
    y_mu_out[task] = y_mu;
    y_sd_out[task] = y_sd;
    n_out[task] = n;
  }
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
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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
  const long long blocks = ((long long)t_total + kWarps - 1) / kWarps;
  bayes_fit_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, y, m, t_total, n_cols, mu, sigma, alpha, beta, x_mu, x_sd, y_mu,
      y_sd, n);
  return static_cast<int>(cudaGetLastError());
}

int lotaru_nig_fold(const double* xs, const double* ys, const int* counts,
                    long long t_total, int k_cols, const double* mu,
                    const double* v, const double* prec, const double* b,
                    double* mu_out, double* v_out, double* prec_out,
                    double* b_out, void* stream) {
  if (t_total <= 0) return 0;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
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
