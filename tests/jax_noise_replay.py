"""JAX's own noise for the port's parity tests.

The JAX objectives draw their noise from a key; the port's take it from
outside. replay_noise redoes JAX's key splits for one objective call and
returns the noise as the port's cores take it: split over the S samples
(`vibo.py` `_mc_mean`/`_mc_stack`, `evaluation.py` `_iwae_block_fn`), item
and theta keys per sample, the item names in sorted order (the JAX
`VIBO.sample_items_from`), and theta eps of mu's shape (the JAX
`distributions.tril_reparameterize`)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def replay_noise(key, num_samples: int, item_shapes: dict, rows: int,
                 k: int):
    """-> ({name: (S, M, D)} item eps, (S, rows, K) theta eps) as CPU
    tensors; item_shapes maps each item param name to its (M, D)."""
    item = {name: [] for name in item_shapes}
    theta = []
    for ks in jax.random.split(key, num_samples):
        k_item, k_theta = jax.random.split(ks)
        for kn, name in zip(jax.random.split(k_item, len(item_shapes)),
                            sorted(item_shapes)):
            item[name].append(np.asarray(jax.random.normal(
                kn, item_shapes[name], jnp.float32)))
        theta.append(np.asarray(jax.random.normal(k_theta, (rows, k),
                                                  jnp.float32)))
    return ({n: torch.from_numpy(np.stack(v)) for n, v in item.items()},
            torch.from_numpy(np.stack(theta)))
