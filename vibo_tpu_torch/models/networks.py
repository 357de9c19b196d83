"""Ability encoder, item posteriors and the deep link (counterpart of
`vibo_tpu.models.networks`, the parts the port's models run).

Parameters are plain trees of tensors in the JAX layout (`w` is (in, out),
`x @ w + b`), so `convert.params_from_jax` carries them over unchanged.

Compute dtype: JAX casts both matmul operands to the compute dtype and
accumulates AND returns f32 (`preferred_element_type=f32`). `cast_through`
reproduces that exactly: bf16 operands carried as f32, whose products are
exact in f32, multiplied in f32 (TF32 is off, `_device.resolve_device`).
The head layer runs in f32, as in JAX.

The deep link's item blocks run under `torch.utils.checkpoint` (the
counterpart of `jax.checkpoint`): their (B, chunk, H) activations are
recomputed in the backward pass instead of kept.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vibo_tpu_torch._device import as_dtype, cast_through
from vibo_tpu_torch.ops import pallas_encoder

# ---------------------------------------------------------------- MLP core


def init_linear(in_dim: int, out_dim: int, generator: torch.Generator,
                device) -> dict:
    """Glorot-uniform weight + zero bias."""
    scale = math.sqrt(6.0 / (in_dim + out_dim))
    u = torch.rand((in_dim, out_dim), generator=generator, device=device)
    return {"w": (2.0 * u - 1.0) * scale,
            "b": torch.zeros((out_dim,), device=device)}


def init_mlp(dims: list[int], generator: torch.Generator, device) -> list:
    """dims = [in, h1, ..., out]; relu between layers, linear output."""
    return [init_linear(dims[i], dims[i + 1], generator, device)
            for i in range(len(dims) - 1)]


def _mm(x, w, cd):
    """x @ w with both operands rounded to cd, f32 accumulate and result."""
    return cast_through(x, cd) @ cast_through(w, cd)


# ------------------------------------------------------- ability encoder


def split_ability_head(out, axis: int = -1):
    """Head output -> (mu, logvar clipped to [-8, 8], None): the diagonal
    family's (mu, logvar) halves along `axis` (0 for the (2K, B) head)."""
    mu, logvar = torch.chunk(out, 2, dim=axis)
    return mu, logvar.clamp(-8.0, 8.0), None


def _hidden_layers(w1, rest, h, m, item_feats, cd):
    """Item-feature projection (rows 2M: of the first layer, once per
    batch), bias, relu, and the hidden layers after the first, all in the
    compute dtype."""
    if item_feats is not None:
        h = h + _mm(item_feats, w1["w"][2 * m:], cd)[..., None, :]
    x = torch.relu(h + w1["b"])
    for layer in rest[:-1]:
        x = torch.relu(_mm(x, layer["w"], cd) + layer["b"])
    return x


def apply_ability_encoder(params, response, mask, item_feats=None,
                          compute_dtype="float32"):
    """Dense encoder on response/mask (B, M): MLP([r*m, m, item_feats]) with
    the concat split into per-block matmuls -> (mu, logvar, None), (B, K)."""
    cd = as_dtype(compute_dtype)
    w1, rest = params[0], params[1:]
    m = response.shape[-1]
    h = (_mm(response * mask, w1["w"][:m], cd)
         + _mm(mask, w1["w"][m:2 * m], cd))
    x = _hidden_layers(w1, rest, h, m, item_feats, cd)
    return split_ability_head(x @ rest[-1]["w"] + rest[-1]["b"])


def apply_ability_encoder_packed(params, packed, item_feats=None,
                                 compute_dtype="float32",
                                 transposed_head: bool = False):
    """apply_ability_encoder on the int8 code: the first layer runs the
    fused decode + dual matmul (`pallas_encoder.packed_first_layer`).

    transposed_head=True returns (mu, logvar) as (K, B) from W^T @ x^T,
    the layout the transposed loglik consumes."""
    cd = as_dtype(compute_dtype)
    w1, rest = params[0], params[1:]
    m = packed.shape[-1]
    h = pallas_encoder.packed_first_layer(packed, w1["w"][:m],
                                          w1["w"][m:2 * m], cd)
    x = _hidden_layers(w1, rest, h, m, item_feats, cd)
    if transposed_head:
        out_t = rest[-1]["w"].T @ x.T + rest[-1]["b"][:, None]
        return split_ability_head(out_t, axis=0)
    return split_ability_head(x @ rest[-1]["w"] + rest[-1]["b"])


# ------------------------------------------------------ item posteriors


def item_head_spec(irt_model: str, ability_dim: int,
                   item_latent_dim: int = 0, num_categories: int = 2) -> dict:
    """Ordered {param_name: dim} for one item's parameters; grm/gpcm: "b"
    holds the C-1 unconstrained category coordinates; deep: "d", the item's
    latent vector of item_latent_dim."""
    if irt_model == "1pl":
        return {"b": 1}
    if irt_model == "2pl":
        return {"a": ability_dim, "b": 1}
    if irt_model == "3pl":
        return {"a": ability_dim, "b": 1, "g_hat": 1}
    if irt_model in ("grm", "gpcm"):
        return {"a": ability_dim, "b": num_categories - 1}
    if irt_model == "deep":
        return {"d": item_latent_dim}
    raise ValueError(irt_model)


def init_item_posterior(num_items: int, irt_model: str, ability_dim: int,
                        generator: torch.Generator, device,
                        item_latent_dim: int = 0,
                        num_categories: int = 2) -> dict:
    """Free-form per-item Gaussians {name: {'mu', 'logvar': (M, D)}}: mu
    ~ 0.1 N(0, 1), logvar -2 (3PL: a, b and the guess logit g_hat;
    grm/gpcm: a and the (M, C-1) b; deep: d)."""
    spec = item_head_spec(irt_model, ability_dim, item_latent_dim,
                          num_categories)
    return {name: {"mu": 0.1 * torch.randn((num_items, d), generator=generator,
                                           device=device),
                   "logvar": torch.full((num_items, d), -2.0, device=device)}
            for name, d in spec.items()}


def item_feat_dim(num_items: int, irt_model: str, ability_dim: int,
                  item_latent_dim: int = 0, num_categories: int = 2) -> int:
    """Flattened width of one item-parameter sample (encoder conditioning)."""
    return num_items * sum(item_head_spec(irt_model, ability_dim,
                                          item_latent_dim,
                                          num_categories).values())


def flatten_item_sample(sample: dict) -> torch.Tensor:
    """Item-sample dict -> feature vector, keys SORTED (a, b, g_hat), each
    item-major, the JAX package's order."""
    return torch.cat([sample[k].reshape(sample[k].shape[:-2] + (-1,))
                      for k in sorted(sample)], dim=-1)


# ------------------------------------------------------------ deep link


def init_deep_link(ability_dim: int, item_latent_dim: int, hidden_dim: int,
                   generator: torch.Generator, device) -> dict:
    """p(r_ij | theta_i, d_j) = Bernoulli(sigmoid(MLP([theta_i, d_j]))), the
    first layer stored split (w_theta (K, H), w_item (D, H), b1) so a pair's
    pre-activation is a broadcast add of two small products; then layer2
    (H, H) and out (H, 1), Glorot-uniform with zero biases."""
    scale = math.sqrt(6.0 / (ability_dim + item_latent_dim + hidden_dim))

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=device)
        return (2.0 * u - 1.0) * scale

    return {"w_theta": uniform((ability_dim, hidden_dim)),
            "w_item": uniform((item_latent_dim, hidden_dim)),
            "b1": torch.zeros((hidden_dim,), device=device),
            "layer2": init_linear(hidden_dim, hidden_dim, generator, device),
            "out": init_linear(hidden_dim, 1, generator, device)}


def apply_deep_link(params, theta, d, item_chunk: int = 0,
                    compute_dtype="float32"):
    """theta (..., B, K), d (..., M, D) -> logits (..., B, M).

    item_chunk > 0 (and M > item_chunk) runs the items in blocks of
    item_chunk, d zero-padded to a multiple of it, each block under
    torch.utils.checkpoint: peak memory O(B * chunk * H) instead of
    O(B * M * H), the activations recomputed in the backward pass. The
    products round their operands to compute_dtype and accumulate and
    return f32 (`cast_through`)."""
    m = d.shape[-2]
    if item_chunk and m > item_chunk:
        d_p = F.pad(d, (0, 0, 0, (-m) % item_chunk))

        def block(dc):
            return apply_deep_link(params, theta, dc,
                                   compute_dtype=compute_dtype)
        # no randomness inside a block, so no RNG state to save and
        # restore (which a CUDA graph's capture would have to allow)
        logits = [checkpoint(block, dc, use_reentrant=False,
                             preserve_rng_state=False)
                  for dc in d_p.split(item_chunk, dim=-2)]
        return torch.cat(logits, -1)[..., :m]
    cd = as_dtype(compute_dtype)
    ht = _mm(theta, params["w_theta"], cd)                    # (..., B, H)
    hd = _mm(d, params["w_item"], cd)                         # (..., M, H)
    h = torch.relu(ht[..., :, None, :] + hd[..., None, :, :] + params["b1"])
    h = torch.relu(_mm(h, params["layer2"]["w"], cd) + params["layer2"]["b"])
    return (_mm(h, params["out"]["w"], cd) + params["out"]["b"])[..., 0]
