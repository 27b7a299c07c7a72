// The float64 posterior predictive of one task row, shared by
// bayes_predict (bayes.cu) and fused_cost (decision_plane.cu), so that the
// two kernels evaluate the same expressions and cannot drift apart.
//
// The terms follow core.bayes.predict_blr_np in its order; built with
// --fmad=false, no multiply-add is contracted, so the result is bitwise
// the host's.  The eleven values are one posterior row as the caller has
// read it: the input x, mu[0] and mu[1], sigma at [0,0], [0,1] and [1,1],
// beta_prec and the standardization (x_mu, x_sd, y_mu, y_sd).
#pragma once

#include <math.h>

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
