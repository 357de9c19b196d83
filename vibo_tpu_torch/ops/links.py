"""IRT link functions (counterpart of `vibo_tpu.ops.links`).

  1PL: p = sigmoid(sum_k theta_k - b_j)
  2PL: p = sigmoid(a_j . theta_i - b_j)
  3PL: p = g_j + (1 - g_j) sigmoid(a_j . theta_i - b_j), g_j = sigmoid(g~_j)

The polytomous families (GRM, GPCM) share the linear predictor base = a_j .
theta_i and an (M, C-1) block of unconstrained item coordinates b, which
`categorical_table` turns into the family's per-item table: the ordered
thresholds (GRM) or the cumulative step sums (GPCM).

Shapes: theta (..., B, K), a (M, K), b (M,) (polytomous: (M, C-1)), g_hat
(M,) -> (..., B, M); the item params may also carry theta's leading sample
axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IRT_MODELS = ("1pl", "2pl", "3pl", "grm", "gpcm", "deep")
CATEGORICAL_MODELS = ("grm", "gpcm")


def logits_1pl(theta, b):
    return theta.sum(-1, keepdim=True) - b[..., None, :]


def logits_2pl(theta, a, b):
    """theta (..., B, K), a (..., M, K), b (..., M) -> (..., B, M); a and b
    may carry theta's leading sample axes or not (shared)."""
    return theta @ a.transpose(-1, -2) - b[..., None, :]


def logits_3pl(theta, a, b):
    return logits_2pl(theta, a, b)


def prob_1pl(theta, b):
    return torch.sigmoid(logits_1pl(theta, b))


def prob_2pl(theta, a, b):
    return torch.sigmoid(logits_2pl(theta, a, b))


def prob_3pl(theta, a, b, g_hat):
    g = torch.sigmoid(g_hat)[..., None, :]
    return g + (1.0 - g) * torch.sigmoid(logits_3pl(theta, a, b))


def response_prob(irt_model: str, theta, item_params: dict):
    """Dispatch: item_params holds keys among {'a', 'b', 'g_hat'}."""
    if irt_model == "1pl":
        return prob_1pl(theta, item_params["b"])
    if irt_model == "2pl":
        return prob_2pl(theta, item_params["a"], item_params["b"])
    if irt_model == "3pl":
        return prob_3pl(theta, item_params["a"], item_params["b"],
                        item_params["g_hat"])
    raise ValueError(f"unknown linear-link irt_model {irt_model!r}")


def grm_thresholds(b_free):
    """Ordered GRM thresholds from the unconstrained (..., M, C-1) block:
    kappa_1 = b_free[..., 0], kappa_{c+1} = kappa_c + softplus(b_free[...,
    c])."""
    first = b_free[..., :1]
    if b_free.shape[-1] == 1:
        return first
    steps = F.softplus(b_free[..., 1:])
    return torch.cat([first, first + torch.cumsum(steps, dim=-1)], dim=-1)


def grm_base(theta, a):
    """The polytomous linear predictor a_j . theta_i -> (..., B, M); a may
    carry theta's leading sample axes or not (shared)."""
    return theta @ a.transpose(-1, -2)


def gpcm_cumsteps(b_free):
    """GPCM cumulative step sums kap_c = sum_{v <= c} delta_v of the
    unconstrained steps (..., M, C-1) (any real steps are valid)."""
    return torch.cumsum(b_free, dim=-1)


def categorical_table(irt_model: str, b_free):
    """(..., M, C-1) per-item category table of a polytomous family."""
    if irt_model == "grm":
        return grm_thresholds(b_free)
    if irt_model == "gpcm":
        return gpcm_cumsteps(b_free)
    raise ValueError(f"not a categorical irt_model: {irt_model!r}")
