// Hand-written Hopper kernels for the Bayesian-linear-regression hot path
// (the paper's Section 4.5 model), built by nvcc into a plain-C shared
// library and bound with ctypes (see kernels/_build.py).
//
// Build flags: -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps every a*b+c as a separately rounded multiply and add,
// which is what lets bayes_predict match the host float64 reference bit for
// bit.  Each C entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

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
// (core.bayes.predict_blr_np), so the result is bitwise equal to it.
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
    const double xs = (x[i] - x_mu[i]) / x_sd[i];
    const double mean_s = mu[2 * i] + mu[2 * i + 1] * xs;
    const double var_s = 1.0 / beta[i] + sigma[4 * i]
                         + 2.0 * sigma[4 * i + 1] * xs
                         + sigma[4 * i + 3] * xs * xs;
    const double ysd = y_sd[i];
    mean[i] = mean_s * ysd + y_mu[i];
    // numpy.maximum(var_s, 0.0): NaN propagates, -0.0 becomes +0.0
    const double v = (var_s <= 0.0) ? 0.0 : var_s;
    std[i] = sqrt(v) * ysd;
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

}  // extern "C"
