"""Synthetic binary IRT response simulator with ground-truth parameters.

A numpy copy of `vibo_tpu.data.synthetic.simulate_irt` for the binary links
(1pl/2pl/3pl): theta ~ N(0, I_K), difficulties ~ N(0, 1), discriminations
~ N(0, 1)/sqrt(K) (ones for 1pl), guess logits ~ N(-1.5, 1) (3pl), responses
Bernoulli(link), optional missing-at-random mask. The same seed draws the same
stream in the same order, so the arrays are byte-identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticIRT:
    """A simulated response matrix plus the ground truth that generated it."""
    response: np.ndarray        # (N, M) float32 in {0, 1}; 0 where unobserved
    mask: np.ndarray            # (N, M) float32, 1 = observed
    theta: np.ndarray           # (N, K) true abilities
    a: np.ndarray               # (M, K) true discriminations (ones for 1pl)
    b: np.ndarray               # (M,) true difficulties
    g_hat: np.ndarray | None    # (M,) true guess logits (3pl only)
    prob: np.ndarray            # (N, M) true response probabilities
    irt_model: str
    seed: int
    num_categories: int = 2


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def simulate_irt(irt_model: str, num_persons: int, num_items: int,
                 ability_dim: int = 1, seed: int = 0,
                 missing_rate: float = 0.0) -> SyntheticIRT:
    """Dense binary responses under a 1pl/2pl/3pl model (see module doc)."""
    if irt_model not in ("1pl", "2pl", "3pl"):
        raise NotImplementedError(
            f"simulate_irt in vibo_tpu_torch covers 1pl/2pl/3pl, got "
            f"{irt_model!r} (nonlinear/grm/gpcm: ROADMAP queue A item 7)")
    rng = np.random.default_rng(seed)
    k = ability_dim
    theta = rng.standard_normal((num_persons, k)).astype(np.float32)
    b = rng.standard_normal(num_items).astype(np.float32)
    if irt_model == "1pl":
        a = np.ones((num_items, k), dtype=np.float32)
        logits = theta.sum(-1, keepdims=True) - b[None, :]
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
    if missing_rate > 0.0:
        mask = (rng.random((num_persons, num_items))
                >= missing_rate).astype(np.float32)
    else:
        mask = np.ones((num_persons, num_items), dtype=np.float32)
    # unobserved responses are zeroed so they can never leak through a bug
    response = response * mask
    return SyntheticIRT(response=response, mask=mask, theta=theta, a=a, b=b,
                        g_hat=g_hat, prob=prob, irt_model=irt_model, seed=seed)
