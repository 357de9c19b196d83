"""Masked log-likelihoods of the binary links and the polytomous families
(counterpart of `vibo_tpu.ops.likelihood`), and the expected Fisher
weights of the linear predictor that the Laplace-anchored posterior
weights its pair statistics by.

log Bernoulli(r | sigmoid(l)) = r*l - softplus(l), never forming
probabilities. 3PL, pi = g + (1-g) sigmoid(l) with g = sigmoid(g~):
  log(1-pi) = -softplus(g~) - softplus(l)
  log(pi)   = logaddexp(-softplus(-g~), -softplus(g~) - softplus(-l))
both exact and overflow-free. Masks multiply in, so missing cells never
produce NaN.

Polytomous responses r in {0..C-1}, base = a_j . theta_i:
- GRM (cumulative logits): P(r) = sigmoid(x) - sigmoid(y), x = base -
  kappa_r, y = base - kappa_{r+1}, kappa_0 = -50 and kappa_C = +50 as
  sentinels, in the stable form -softplus(-x) - softplus(y) + log1p(-e^(y-x))
  with the gap y - x clamped to -1e-6 and base to +-30.
- GPCM (adjacent-category logits): P(r) = softmax_c(z_c), z_c = c base -
  kap_c, z_0 = 0.
The per-item tables (..., M, C-1) come from `links.categorical_table`; they
may carry the base's leading sample axes (the port runs samples batched
where JAX vmaps them)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vibo_tpu_torch.ops.distributions import floor_at


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


def masked_loglik_total(logits, response, mask, g_hat=None):
    """Scalar masked log-likelihood over all cells."""
    return masked_loglik_per_person(logits, response, mask, g_hat).sum()


_GRM_BIG = 50.0     # boundary-category sentinel threshold
_GRM_CLAMP = 30.0   # base saturation, keeps |base| far from the sentinels


def graded_loglik_cells(base, kappa, response, mask):
    """Elementwise masked GRM log P(r | base, kappa): base (..., B, M),
    kappa (..., M, C-1) ordered thresholds, response float categories."""
    base = base.clamp(-_GRM_CLAMP, _GRM_CLAMP)
    lo = torch.full_like(base, -_GRM_BIG)           # kappa_r
    hi = torch.full_like(base, _GRM_BIG)            # kappa_{r+1}
    for c in range(kappa.shape[-1]):
        kc = kappa[..., None, :, c]
        lo = torch.where(response == c + 1, kc, lo)
        hi = torch.where(response == c, kc, hi)
    x, y = base - lo, base - hi
    d = (lo - hi).clamp(max=-1e-6)
    ll = -F.softplus(-x) - F.softplus(y) + torch.log1p(-torch.exp(d))
    return mask * ll


def graded_logprob_all(base, kappa):
    """All-category GRM log-probabilities -> (..., B, M, C)."""
    base = base.clamp(-_GRM_CLAMP, _GRM_CLAMP)
    pad = torch.ones(kappa.shape[:-1] + (1,), dtype=kappa.dtype,
                     device=kappa.device)
    lo = torch.cat([-_GRM_BIG * pad, kappa], -1)[..., None, :, :]
    hi = torch.cat([kappa, _GRM_BIG * pad], -1)[..., None, :, :]
    x, y = base[..., None] - lo, base[..., None] - hi
    d = (lo - hi).clamp(max=-1e-6)
    return -F.softplus(-x) - F.softplus(y) + torch.log1p(-torch.exp(d))


def graded_loglik_per_person(base, kappa, response, mask):
    return graded_loglik_cells(base, kappa, response, mask).sum(-1)


def gpcm_loglik_cells(base, kap, response, mask):
    """Elementwise masked GPCM log P(r | base, kap): kap (..., M, C-1)
    cumulative step sums."""
    zr = torch.zeros_like(base)                     # z_0 = 0
    mx = torch.zeros_like(base)
    zs = []
    for c in range(kap.shape[-1]):
        z = (c + 1) * base - kap[..., None, :, c]
        zs.append(z)
        zr = torch.where(response == c + 1, z, zr)
        mx = torch.maximum(mx, z)
    s = torch.exp(-mx)
    for z in zs:
        s = s + torch.exp(z - mx)
    return mask * (zr - mx - torch.log(s))


def gpcm_logprob_all(base, kap):
    """All-category GPCM log-probabilities -> (..., B, M, C)."""
    cats = torch.arange(1, kap.shape[-1] + 1, dtype=base.dtype,
                        device=base.device)
    z = base[..., None] * cats - kap[..., None, :, :]
    z = torch.cat([torch.zeros_like(z[..., :1]), z], -1)
    return torch.log_softmax(z, dim=-1)


def gpcm_loglik_per_person(base, kap, response, mask):
    return gpcm_loglik_cells(base, kap, response, mask).sum(-1)


def categorical_loglik_cells(irt_model: str, base, table, response, mask):
    if irt_model == "grm":
        return graded_loglik_cells(base, table, response, mask)
    if irt_model == "gpcm":
        return gpcm_loglik_cells(base, table, response, mask)
    raise ValueError(f"not a categorical irt_model: {irt_model!r}")


def categorical_loglik_per_person(irt_model: str, base, table, response,
                                  mask):
    return categorical_loglik_cells(irt_model, base, table, response,
                                    mask).sum(-1)


def categorical_logprob_all(irt_model: str, base, table):
    if irt_model == "grm":
        return graded_logprob_all(base, table)
    if irt_model == "gpcm":
        return gpcm_logprob_all(base, table)
    raise ValueError(f"not a categorical irt_model: {irt_model!r}")


def categorical_fisher_weight(irt_model: str, base, table):
    if irt_model == "grm":
        return graded_fisher_weight(base, table)
    if irt_model == "gpcm":
        return gpcm_fisher_weight(base, table)
    raise ValueError(f"not a categorical irt_model: {irt_model!r}")


# ------------------------------------------------- expected Fisher weights
#
# Per-cell expected information of the linear predictor eta: the w_ij of
# the closed-form Laplace covariance (I + sum_j m_ij w_ij a_j a_j^T)^-1
# (evaluation.laplace_sigma_from_items has the numpy twins).


def bernoulli_fisher_weight(logits):
    """w = p(1-p) for the 1PL/2PL Bernoulli likelihood."""
    s = torch.sigmoid(logits)
    return s * (1.0 - s)


def fisher_weight_3pl(logits, g_hat):
    """3PL: w = ((1-g) s(1-s))^2 / (p(1-p)), g = sigmoid(g_hat) (..., M)."""
    g = torch.sigmoid(g_hat)[..., None, :]
    s = torch.sigmoid(logits)
    p = g + (1.0 - g) * s
    num = torch.square((1.0 - g) * s * (1.0 - s))
    return num / floor_at(p * (1.0 - p), 1e-12)


def graded_fisher_weight(base, kappa):
    """GRM: w = sum_c (s'_c - s'_{c+1})^2 / P_c, s_c = sigmoid(base -
    kappa_c), the boundary derivatives 0. Forms the (..., B, M, C) axis."""
    sc = torch.sigmoid(base[..., None] - kappa[..., None, :, :])
    z = torch.zeros(sc.shape[:-1] + (1,), dtype=sc.dtype, device=sc.device)
    s_lo = torch.cat([torch.ones_like(z), sc], -1)          # P(>= c)
    s_hi = torch.cat([sc, z], -1)                           # P(>= c+1)
    pcat = floor_at(s_lo - s_hi, 1e-12)
    d = sc * (1.0 - sc)
    d_lo = torch.cat([z, d], -1)
    d_hi = torch.cat([d, z], -1)
    return (torch.square(d_lo - d_hi) / pcat).sum(-1)


def gpcm_fisher_weight(base, kap):
    """GPCM: w = Var[c] under the category softmax (the expected
    information of base). Forms the (..., B, M, C) axis."""
    p = torch.exp(gpcm_logprob_all(base, kap))
    cats = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
    e1 = (p * cats).sum(-1)
    e2 = (p * cats * cats).sum(-1)
    return e2 - e1 * e1
