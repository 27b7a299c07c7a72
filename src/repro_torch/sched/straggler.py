"""The inverse normal of the decision plane (the speculation policy of the
reference's straggler module is not part of this package yet).

`ndtri` here is the shared inverse-normal of the whole decision plane: the
quantile-HEFT path (`sched.plane.quantile_z`), carbon/cost confidence
bookings, and the speculation threshold all call it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# Wichura's AS 241 (PPND16) rational approximations: exact to double
# precision (|rel err| < 1e-15), unlike the ~1e-9 Acklam polynomial this
# replaced.  Coefficients are the published constants, Horner-ordered
# highest degree first.
_A = (2.5090809287301226727e+3, 3.3430575583588128105e+4,
      6.7265770927008700853e+4, 4.5921953931549871457e+4,
      1.3731693765509461125e+4, 1.9715909503065514427e+3,
      1.3314166789178437745e+2, 3.3871328727963666080e+0)
_B = (5.2264952788528545610e+3, 2.8729085735721942674e+4,
      3.9307895800092710610e+4, 2.1213794301586595867e+4,
      5.3941960214247511077e+3, 6.8718700749205790830e+2,
      4.2313330701600911252e+1, 1.0)
_C = (7.74545014278341407640e-4, 2.27238449892691845833e-2,
      2.41780725177450611770e-1, 1.27045825245236838258e+0,
      3.64784832476320460504e+0, 5.76949722146069140550e+0,
      4.63033784615654529590e+0, 1.42343711074968357734e+0)
_D = (1.05075007164441684324e-9, 5.47593808499534494600e-4,
      1.51986665636164571966e-2, 1.48103976427480074590e-1,
      6.89767334985100004550e-1, 1.67638483018380384940e+0,
      2.05319162663775882187e+0, 1.0)
_E = (2.01033439929228813265e-7, 2.71155556874348757815e-5,
      1.24266094738807843860e-3, 2.65321895265761230930e-2,
      2.96560571828504891230e-1, 1.78482653991729133580e+0,
      5.46378491116411436990e+0, 6.65790464350110377720e+0)
_F = (2.04426310338993978564e-15, 1.42151175831644588870e-7,
      1.84631831751005468180e-5, 7.86869131145613259100e-4,
      1.48753612908506148525e-2, 1.36929880922735805310e-1,
      5.99832206555887937690e-1, 1.0)


def _horner(coeffs, r: np.ndarray) -> np.ndarray:
    acc = np.full_like(r, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * r + c
    return acc


def ndtri(p) -> np.ndarray:
    """Vectorized inverse standard-normal CDF (AS 241, double precision).

    Accepts scalars or arrays; p is clamped to (1e-12, 1 - 1e-12) so the
    decision plane never produces infinities from a saturated quantile."""
    p = np.clip(np.asarray(p, np.float64), 1e-12, 1.0 - 1e-12)
    q = p - 0.5
    central = np.abs(q) <= 0.425
    # central region: z = q * A(r)/B(r) with r = 0.180625 - q^2
    r_c = 0.180625 - q * q
    z_c = q * _horner(_A, r_c) / _horner(_B, r_c)
    # tails: r = sqrt(-log(min(p, 1-p))), two rational regimes
    tail_p = np.where(q < 0.0, p, 1.0 - p)
    # clamp keeps log's argument positive on the lanes the central branch
    # will overwrite anyway (np.where evaluates both)
    r_t = np.sqrt(-np.log(np.maximum(tail_p, 1e-300)))
    near = r_t <= 5.0
    r_n = r_t - 1.6
    r_f = r_t - 5.0
    z_t = np.where(near, _horner(_C, r_n) / _horner(_D, r_n),
                   _horner(_E, r_f) / _horner(_F, r_f))
    z_t = np.where(q < 0.0, -z_t, z_t)
    return np.where(central, z_c, z_t)


# scalar z-scores are asked for on every planning round / speculation
# heartbeat, always at a handful of distinct q values — memoize them (the
# cached value is exactly float(ndtri(q)), so cached and uncached callers
# stay bit-identical)
_Z_CACHE: Dict[float, float] = {}


def cached_z(q: float) -> float:
    """float(ndtri(q)) memoized per scalar quantile."""
    z = _Z_CACHE.get(q)
    if z is None:
        z = _Z_CACHE[q] = float(ndtri(q))
    return z


def normal_quantile(mean, std, q=0.95):
    """N(mean, std) inverse CDF; vectorized over mean/std/q.  Returns a
    float for scalar inputs, an ndarray otherwise."""
    z = cached_z(float(q)) if isinstance(q, (int, float)) else ndtri(q)
    out = np.asarray(mean, np.float64) + np.asarray(std, np.float64) * z
    return float(out) if out.ndim == 0 else out
