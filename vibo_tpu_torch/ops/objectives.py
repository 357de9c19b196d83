"""ELBO and IWAE bounds (counterpart of `vibo_tpu.ops.objectives`)."""

from __future__ import annotations

import math

import torch


def elbo(loglik, kl_theta, kl_items, item_scale=1.0):
    """ELBO = E_q[log p(r|theta,d)] - KL_theta - item_scale * KL_items."""
    return loglik - kl_theta - item_scale * kl_items


def iwae_bound(log_w, axis: int = 0):
    """log (1/S) sum_s exp(log_w_s) over the sample axis."""
    s = log_w.shape[axis]
    return torch.logsumexp(log_w, dim=axis) - math.log(float(s))


def importance_log_weights(loglik_s, log_p_theta_s, log_q_theta_s,
                           log_p_items_s=None, log_q_items_s=None,
                           item_scale=1.0):
    """Per-sample joint log-weights; item terms scaled by item_scale."""
    log_w = loglik_s + log_p_theta_s - log_q_theta_s
    if log_p_items_s is not None:
        log_w = log_w + item_scale * (log_p_items_s - log_q_items_s)
    return log_w
