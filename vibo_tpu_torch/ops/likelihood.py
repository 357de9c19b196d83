"""Masked Bernoulli log-likelihood for the binary links (counterpart of
`vibo_tpu.ops.likelihood`, 1PL/2PL part).

log Bernoulli(r | sigmoid(l)) = r*l - softplus(l), never forming
probabilities; masks multiply in, so missing cells never produce NaN."""

from __future__ import annotations

import torch.nn.functional as F


def bernoulli_loglik_from_logits(logits, response, mask):
    """Elementwise mask * (r*l - softplus(l))."""
    return mask * (response * logits - F.softplus(logits))


def masked_loglik_per_person(logits, response, mask, g_hat=None):
    """Sum of the masked Bernoulli log-lik over the item axis -> (..., B)."""
    if g_hat is not None:
        raise NotImplementedError("the 3PL likelihood is ROADMAP queue A item 9")
    return bernoulli_loglik_from_logits(logits, response, mask).sum(-1)
