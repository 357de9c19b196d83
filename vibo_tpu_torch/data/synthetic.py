"""Synthetic IRT response simulators with ground-truth parameters.

A numpy copy of `vibo_tpu.data.synthetic.simulate_irt` for the binary links
(1pl/2pl/3pl): theta ~ N(0, I_K), difficulties ~ N(0, 1), discriminations
~ N(0, 1)/sqrt(K) (ones for 1pl), guess logits ~ N(-1.5, 1) (3pl), responses
Bernoulli(link), optional missing-at-random mask; of its "nonlinear" family
(a fixed random tanh-MLP link over (theta, item embedding) pairs, the data
the deep link is built for); and of `simulate_grm` / `simulate_gpcm` for the
polytomous families (categories 0..C-1). The same seed draws the same
stream in the same order, so the arrays are byte-identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticIRT:
    """A simulated response matrix plus the ground truth that generated it."""
    response: np.ndarray        # (N, M) float32 in {0, 1} (grm/gpcm:
                                # {0..C-1}); 0 where unobserved
    mask: np.ndarray            # (N, M) float32, 1 = observed
    theta: np.ndarray           # (N, K) true abilities
    a: np.ndarray               # (M, K) true discriminations (ones for 1pl;
                                # the item embeddings for "nonlinear")
    b: np.ndarray               # (M,) true difficulties (grm: (M, C-1)
                                # ordered thresholds; gpcm: (M, C-1) steps)
    g_hat: np.ndarray | None    # (M,) true guess logits (3pl only)
    prob: np.ndarray            # (N, M) true response probabilities
                                # (grm/gpcm: expected score E[r]/(C-1))
    irt_model: str
    seed: int
    num_categories: int = 2


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _nonlinear_logits(rng, theta, d, b):
    """The "nonlinear" family's logits (N, M): a fixed random tanh-MLP over
    [theta_i; d_j] (hidden 32, weights drawn from rng) plus a squared
    theta . d interaction, standardized to sd 1.6, minus b, clipped to
    +-10. A bilinear 2PL cannot fit these curves; the deep link can."""
    k, kd = theta.shape[1], d.shape[1]
    hidden = 32
    w1 = rng.standard_normal((k + kd, hidden)) / np.sqrt(k + kd)
    c1 = rng.standard_normal(hidden) * 0.3
    w2 = rng.standard_normal(hidden) / np.sqrt(hidden)
    t_proj = theta @ w1[:k]                                   # (N, H)
    d_proj = d @ w1[k:] + c1                                  # (M, H)
    h = np.tanh(t_proj[:, None, :] + d_proj[None, :, :])      # (N, M, H)
    mlp = h @ w2
    inter = np.square(theta @ d.T) / np.sqrt(max(k, kd))
    raw = 2.2 * mlp + 0.8 * inter
    raw = (raw - raw.mean()) / (raw.std() + 1e-8) * 1.6
    return np.clip(raw - b[None, :], -10.0, 10.0)


def _missing_mask(rng, num_persons: int, num_items: int,
                  missing_rate: float) -> np.ndarray:
    if missing_rate > 0.0:
        return (rng.random((num_persons, num_items))
                >= missing_rate).astype(np.float32)
    return np.ones((num_persons, num_items), dtype=np.float32)


def simulate_grm(num_persons: int, num_items: int, ability_dim: int = 1,
                 num_categories: int = 5, seed: int = 0,
                 missing_rate: float = 0.0) -> SyntheticIRT:
    """Ordinal responses under the graded response model, P(r >= c) =
    sigmoid(a_j . theta_i - kappa_jc): kappa_1 ~ N(-1, 0.5^2) with
    softplus(N(0, 1)) increments; one uniform a cell, r = #{c : u < P(>=
    c)}."""
    rng = np.random.default_rng(seed)
    k, c = ability_dim, num_categories
    if c < 3:
        raise ValueError("simulate_grm needs num_categories >= 3")
    theta = rng.standard_normal((num_persons, k)).astype(np.float32)
    a = (rng.standard_normal((num_items, k)) / np.sqrt(k)).astype(np.float32)
    first = (-1.0 + 0.5 * rng.standard_normal((num_items, 1)))
    steps = np.logaddexp(0.0, rng.standard_normal((num_items, c - 2)))
    kappa = np.concatenate([first, first + np.cumsum(steps, -1)],
                           -1).astype(np.float32)
    base = theta @ a.T                                        # (N, M)
    p_ge = _sigmoid(base[..., None] - kappa[None])            # (N, M, C-1)
    u = rng.random((num_persons, num_items, 1))
    response = (u < p_ge).sum(-1).astype(np.float32)
    mask = _missing_mask(rng, num_persons, num_items, missing_rate)
    response = response * mask
    expected = p_ge.sum(-1).astype(np.float32) / (c - 1)      # E[r]/(C-1)
    return SyntheticIRT(response=response, mask=mask, theta=theta, a=a,
                        b=kappa, g_hat=None, prob=expected, irt_model="grm",
                        seed=seed, num_categories=c)


def simulate_gpcm(num_persons: int, num_items: int, ability_dim: int = 1,
                  num_categories: int = 5, seed: int = 0,
                  missing_rate: float = 0.0) -> SyntheticIRT:
    """Ordinal responses under the generalized partial credit model, P(r =
    c) = softmax_c(c a_j . theta_i - sum_{v <= c} delta_jv): steps
    delta_jv ~ N(beta_j, 0.5^2), beta_j ~ N(0, 1); person blocks of 2,048,
    one uniform a cell against the category CDF. `b` holds the steps."""
    rng = np.random.default_rng(seed)
    k, c = ability_dim, num_categories
    if c < 3:
        raise ValueError("simulate_gpcm needs num_categories >= 3")
    theta = rng.standard_normal((num_persons, k)).astype(np.float32)
    a = (rng.standard_normal((num_items, k)) / np.sqrt(k)).astype(np.float32)
    beta = rng.standard_normal((num_items, 1))
    delta = (beta + 0.5 * rng.standard_normal((num_items, c - 1))
             ).astype(np.float32)
    kap = np.cumsum(delta, -1)                                # (M, C-1)
    cats = np.arange(1, c, dtype=np.float32)
    response = np.empty((num_persons, num_items), np.float32)
    expected = np.empty((num_persons, num_items), np.float32)
    for s in range(0, num_persons, 2048):
        e = min(s + 2048, num_persons)
        base = theta[s:e] @ a.T                               # (B, M)
        z = base[..., None] * cats - kap[None]                # (B, M, C-1)
        z = np.concatenate(
            [np.zeros(z.shape[:-1] + (1,), np.float32), z], -1)
        z -= z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)                         # (B, M, C)
        cdf = np.cumsum(p[..., :-1], -1)                      # P(r <= c)
        u = rng.random((e - s, num_items, 1), np.float32)
        response[s:e] = (u > cdf).sum(-1)
        expected[s:e] = (p * np.arange(c, dtype=np.float32)).sum(-1) / (c - 1)
    mask = _missing_mask(rng, num_persons, num_items, missing_rate)
    response = response * mask
    return SyntheticIRT(response=response, mask=mask, theta=theta, a=a,
                        b=delta, g_hat=None, prob=expected, irt_model="gpcm",
                        seed=seed, num_categories=c)


def simulate_irt(irt_model: str, num_persons: int, num_items: int,
                 ability_dim: int = 1, seed: int = 0,
                 missing_rate: float = 0.0,
                 num_categories: int = 5) -> SyntheticIRT:
    """Dense responses under a 1pl/2pl/3pl or the nonlinear model (see
    module doc), or ordinal ones under grm/gpcm (num_categories applies
    only there)."""
    if irt_model == "grm":
        return simulate_grm(num_persons, num_items, ability_dim,
                            num_categories, seed, missing_rate)
    if irt_model == "gpcm":
        return simulate_gpcm(num_persons, num_items, ability_dim,
                             num_categories, seed, missing_rate)
    if irt_model not in ("1pl", "2pl", "3pl", "nonlinear"):
        raise ValueError(f"simulate_irt supports 1pl/2pl/3pl/nonlinear/grm/"
                         f"gpcm, got {irt_model!r}")
    rng = np.random.default_rng(seed)
    k = ability_dim
    theta = rng.standard_normal((num_persons, k)).astype(np.float32)
    b = rng.standard_normal(num_items).astype(np.float32)
    if irt_model == "1pl":
        a = np.ones((num_items, k), dtype=np.float32)
        logits = theta.sum(-1, keepdims=True) - b[None, :]
    elif irt_model == "nonlinear":
        a = (rng.standard_normal((num_items, k)) / np.sqrt(k)).astype(np.float32)
        logits = _nonlinear_logits(rng, theta, a, 0.7 * b).astype(np.float32)
    else:
        a = (rng.standard_normal((num_items, k)) / np.sqrt(k)).astype(np.float32)
        logits = theta @ a.T - b[None, :]
    if irt_model == "3pl":
        g_hat = (rng.standard_normal(num_items) - 1.5).astype(np.float32)
        g = _sigmoid(g_hat)[None, :]
        prob = g + (1.0 - g) * _sigmoid(logits)
    else:
        g_hat = None
        prob = _sigmoid(logits)
    prob = prob.astype(np.float32)
    response = (rng.random((num_persons, num_items)) < prob).astype(np.float32)
    mask = _missing_mask(rng, num_persons, num_items, missing_rate)
    # unobserved responses are zeroed so they can never leak through a bug
    response = response * mask
    return SyntheticIRT(response=response, mask=mask, theta=theta, a=a, b=b,
                        g_hat=g_hat, prob=prob, irt_model=irt_model, seed=seed)
