"""Masked Bernoulli log-likelihood for the binary links (counterpart of
`vibo_tpu.ops.likelihood`, 1PL/2PL/3PL part).

log Bernoulli(r | sigmoid(l)) = r*l - softplus(l), never forming
probabilities. 3PL, pi = g + (1-g) sigmoid(l) with g = sigmoid(g~):
  log(1-pi) = -softplus(g~) - softplus(l)
  log(pi)   = logaddexp(-softplus(-g~), -softplus(g~) - softplus(-l))
both exact and overflow-free. Masks multiply in, so missing cells never
produce NaN."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bernoulli_loglik_from_logits(logits, response, mask):
    """Elementwise mask * (r*l - softplus(l))."""
    return mask * (response * logits - F.softplus(logits))


def bernoulli_loglik_3pl(logits, g_hat, response, mask):
    """Elementwise masked 3PL log-lik with guess prob g = sigmoid(g_hat);
    logits (..., B, M), g_hat (M,) or with the logits' leading sample axes
    (..., M), as the port runs samples batched where JAX vmaps them."""
    g_hat = g_hat[..., None, :]
    log_pi = torch.logaddexp(-F.softplus(-g_hat),
                             -F.softplus(g_hat) - F.softplus(-logits))
    log_1m_pi = -F.softplus(g_hat) - F.softplus(logits)
    return mask * (response * log_pi + (1.0 - response) * log_1m_pi)


def masked_loglik_per_person(logits, response, mask, g_hat=None):
    """Sum of the masked Bernoulli log-lik over the item axis -> (..., B);
    g_hat given: the 3PL link."""
    if g_hat is None:
        cells = bernoulli_loglik_from_logits(logits, response, mask)
    else:
        cells = bernoulli_loglik_3pl(logits, g_hat, response, mask)
    return cells.sum(-1)
