"""Parameter trees between the JAX package and the port.

Both packages keep the same tree:

    {"encoder":   [{"w": (in, out), "b": (out,)}, ...],      x @ w + b
     "item_post": {"a": {"mu": (M, K), "logvar": (M, K)},
                   "b": {"mu": (M, 1), "logvar": (M, 1)},
                   "g_hat": {"mu": (M, 1), "logvar": (M, 1)}}}   # 3PL only

(1PL has "b" alone; GRM and GPCM have "a" and a "b" of (M, C-1), the C-1
unconstrained category coordinates; the deep link has "d" (M, D) alone and
adds the link's own tree

     "deep_link": {"w_theta": (K, H), "w_item": (D, H), "b1": (H,),
                   "layer2": {"w": (H, H), "b": (H,)},
                   "out": {"w": (H, 1), "b": (1,)}}),

With the amortized item encoder (item_encoder=True) "item_post" gives way
to the encoder's layers and the training items' residuals,

     "item_enc":   [{"w": (6, Hi), "b": (Hi,)}, {"w": (Hi, Hi), ...},
                    {"w": (Hi, 2 D), "b": (2 D,)}],   D = sum of the widths
     "item_resid": {"a": {"mu": (M, K), "logvar": (M, K)}, "b": ...},

and the encoder's first layer has 2M + F input rows, F the conditioning's
width (M times the item widths under condition_on "sample"/"mean", Fr + Fm
under "stats", 0 under mean-field); its head 2K outputs, 2K + K(K-1)/2 under
theta_posterior "chol" at K > 1. The walk below carries every such tree,
so a tree of numpy arrays (`jax.tree.map(np.asarray, params)`) crosses in
either direction unchanged. Leaves are float32 tensors that require grad.
"""

from __future__ import annotations

import numpy as np
import torch

from vibo_tpu_torch._device import resolve_device


def tree_map(fn, tree):
    """Apply fn to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def params_from_jax(tree, device=None) -> dict:
    """A tree of numpy arrays (the JAX params) -> trainable torch leaves."""
    dev = resolve_device(device)
    return tree_map(
        lambda x: torch.tensor(np.asarray(x, np.float32), device=dev,
                               requires_grad=True), tree)


def params_to_numpy(params) -> dict:
    """Port params -> a tree of float32 numpy arrays (the JAX layout)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
