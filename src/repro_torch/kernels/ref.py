"""Plain PyTorch versions of the hand-written CUDA kernels.

They run on CPU tensors (the kernel wrappers in `kernels.ops` take them
only there) and are what the kernels are held against on the card: the
same function on the same inputs, with no claim to speed."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bayes import fit_blr_batch


def bayes_fit_ref(x: torch.Tensor, y: torch.Tensor,
                  mask: torch.Tensor) -> dict:
    """Batched MacKay evidence fit: the batched `fit_blr` of core.bayes.
    (T, N) float32 x, y, mask -> posterior dict with leaves stacked over T.
    The CUDA kernel, with its closed-form 2x2 algebra and its own reduction
    order, matches it at rtol 5e-3 / atol 5e-4."""
    return fit_blr_batch(x, y, mask)


def bayes_predict_ref(x: torch.Tensor, post: dict
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference batched posterior predictive in float64, term for term the
    expressions of core.bayes.predict_blr_np (so it is bitwise equal to it).
    x: (Q,), post leaves gathered per query (Q, ...)."""
    mu, sig = post["mu"], post["sigma"]
    xs = (x - post["x_mu"]) / post["x_sd"]
    mean_s = mu[:, 0] + mu[:, 1] * xs
    var_s = 1.0 / post["beta_prec"] + sig[:, 0, 0] \
        + 2.0 * sig[:, 0, 1] * xs + sig[:, 1, 1] * xs * xs
    mean = mean_s * post["y_sd"] + post["y_mu"]
    # numpy.maximum(var_s, 0.0): NaN propagates, -0.0 becomes +0.0
    var_s = torch.where(var_s <= 0.0, 0.0, var_s)
    return mean, _sqrt_rn(var_s) * post["y_sd"]


def _sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root of v >= 0 (or NaN).

    On the CPU, torch.sqrt of a float64 tensor goes through MKL's vector
    sqrt, which is off by an ulp on some inputs, so it would break the
    bitwise contract with numpy and with the kernel's IEEE `sqrt`.  The
    complex128 path reaches the C library's csqrt, which returns the
    correctly rounded real sqrt for a non-negative real argument."""
    return torch.sqrt(v.to(torch.complex128)).real
