"""IRT link functions, binary part (counterpart of `vibo_tpu.ops.links`).

  1PL: p = sigmoid(sum_k theta_k - b_j)
  2PL: p = sigmoid(a_j . theta_i - b_j)
  3PL: p = g_j + (1 - g_j) sigmoid(a_j . theta_i - b_j), g_j = sigmoid(g~_j)

Shapes: theta (..., B, K), a (M, K), b (M,), g_hat (M,) -> (..., B, M); the
item params may also carry theta's leading sample axes.
"""

from __future__ import annotations

import torch

IRT_MODELS = ("1pl", "2pl", "3pl", "grm", "gpcm", "deep")


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
