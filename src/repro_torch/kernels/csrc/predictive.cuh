// The float64 posterior predictive of one task row, shared by
// bayes_predict (bayes.cu) and fused_cost (decision_plane.cu), so that the
// two kernels read the same slab layout, evaluate the same expressions and
// cannot drift apart.
//
// The terms follow core.bayes.predict_blr_np in its order; built with
// --fmad=false, no multiply-add is contracted, so the result is bitwise
// the host's.  The eleven values are one posterior row as the caller has
// read it: the input x, mu[0] and mu[1], sigma at [0,0], [0,1] and [1,1],
// beta_prec and the standardization (x_mu, x_sd, y_mu, y_sd).
#pragma once

#include <math.h>

// float64 slots a query takes in a packed slab (kernels.bayes_fit.
// QUERY_SLOTS): for q queries and p = q rounded up to even, x at slot 0,
// mu (q, 2) at p, sigma (q, 2, 2) at 3p, beta_prec, x_mu, x_sd, y_mu and
// y_sd at 7p to 11p, the destination index (int64) at 12p; every group
// starts on a 16-byte boundary when the slab does.
constexpr int kQuerySlots = 13;

__device__ __forceinline__ void lotaru_predictive(
    double x, double mu0, double mu1, double s00, double s01, double s11,
    double beta, double x_mu, double x_sd, double y_mu, double y_sd,
    double* mean, double* std) {
  const double xs = (x - x_mu) / x_sd;
  const double mean_s = mu0 + mu1 * xs;
  const double var_s = 1.0 / beta + s00 + 2.0 * s01 * xs + s11 * xs * xs;
  *mean = mean_s * y_sd + y_mu;
  // numpy.maximum(var_s, 0.0): NaN propagates, -0.0 becomes +0.0
  const double v = (var_s <= 0.0) ? 0.0 : var_s;
  *std = sqrt(v) * y_sd;
}

// The predictive of query i of a packed slab of p-slot groups: a warp's
// lanes on consecutive queries read each group coalesced (mu and
// sigma[0, 0:2] as 16-byte loads).
__device__ __forceinline__ void lotaru_slab_predictive(
    const double* __restrict__ slab, long long p, long long i, double* mean,
    double* std) {
  const double2 mu = reinterpret_cast<const double2*>(slab + p)[i];
  const double* sig = slab + 3 * p + 4 * i;
  const double2 s = *reinterpret_cast<const double2*>(sig);   // [0,0], [0,1]
  lotaru_predictive(slab[i], mu.x, mu.y, s.x, s.y, sig[3], slab[7 * p + i],
                    slab[8 * p + i], slab[9 * p + i], slab[10 * p + i],
                    slab[11 * p + i], mean, std);
}
