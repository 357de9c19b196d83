"""Diagonal Gaussian building blocks (counterpart of
`vibo_tpu.ops.distributions`, diagonal family). Scale is carried as logvar."""

from __future__ import annotations

import torch

LOG2PI = 1.8378770664093453  # log(2*pi)


def reparameterize_eps(eps, mu, logvar):
    """z = mu + sigma * eps with exogenous noise eps."""
    return mu + torch.exp(0.5 * logvar) * eps


def kl_standard_normal(mu, logvar):
    """Elementwise KL(N(mu, exp(logvar)) || N(0, 1))."""
    return 0.5 * (torch.square(mu) + torch.exp(logvar) - logvar - 1.0)


def gaussian_log_prob(z, mu, logvar):
    """Elementwise log N(z; mu, exp(logvar))."""
    return -0.5 * (LOG2PI + logvar + torch.square(z - mu) * torch.exp(-logvar))


def standard_normal_log_prob(z):
    """Elementwise log N(z; 0, 1)."""
    return -0.5 * (LOG2PI + torch.square(z))


def tril_marginal_sigma(logvar, off=None):
    """Per-dimension marginal posterior sds; the diagonal family only
    (full-covariance posteriors: ROADMAP's "Posterior and conditioning
    families")."""
    if off is not None and off.shape[-1]:
        raise NotImplementedError(
            "full-covariance (chol) posteriors come with ROADMAP's "
            "'Posterior and conditioning families'")
    return torch.sqrt(torch.exp(logvar))
