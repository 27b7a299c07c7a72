// The float64 posterior predictive of one task row, shared by
// bayes_predict (bayes.cu) and fused_cost (decision_plane.cu), so that the
// two kernels evaluate the same expressions and cannot drift apart.
//
// The terms follow core.bayes.predict_blr_np in its order; built with
// --fmad=false, no multiply-add is contracted, so the result is bitwise
// the host's.  Leaves are the stacked posterior rows: mu (Q, 2),
// sigma (Q, 2, 2) read at [0,0], [0,1] and [1,1], and the (Q,) scalars.
#pragma once

#include <math.h>

__device__ __forceinline__ void lotaru_predictive(
    const double* __restrict__ x, const double* __restrict__ mu,
    const double* __restrict__ sigma, const double* __restrict__ beta,
    const double* __restrict__ x_mu, const double* __restrict__ x_sd,
    const double* __restrict__ y_mu, const double* __restrict__ y_sd,
    long long i, double* mean, double* std) {
  const double xs = (x[i] - x_mu[i]) / x_sd[i];
  const double mean_s = mu[2 * i] + mu[2 * i + 1] * xs;
  const double var_s = 1.0 / beta[i] + sigma[4 * i]
                       + 2.0 * sigma[4 * i + 1] * xs
                       + sigma[4 * i + 3] * xs * xs;
  const double ysd = y_sd[i];
  *mean = mean_s * ysd + y_mu[i];
  // numpy.maximum(var_s, 0.0): NaN propagates, -0.0 becomes +0.0
  const double v = (var_s <= 0.0) ? 0.0 : var_s;
  *std = sqrt(v) * ysd;
}
