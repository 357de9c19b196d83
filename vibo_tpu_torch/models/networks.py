"""Ability encoder, item posteriors, the conditioning statistics, the
amortized item encoder and the deep link (counterpart of
`vibo_tpu.models.networks`, single device).

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
from vibo_tpu_torch.ops import links, pallas_encoder
from vibo_tpu_torch.ops.packing import decode_packed
from vibo_tpu_torch.parallel.mesh import group_size, psum

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


def ability_head_dim(ability_dim: int, chol: bool = False) -> int:
    """Encoder-head width: (mu, logvar), plus the K(K-1)/2 strict-lower
    Cholesky entries for the full-covariance family."""
    extra = (ability_dim * (ability_dim - 1)) // 2 if chol else 0
    return 2 * ability_dim + extra


def init_ability_encoder(num_items: int, item_feat_dim: int,
                         ability_dim: int, hidden_dim: int,
                         generator: torch.Generator, device,
                         chol: bool = False) -> list:
    """q(theta_i | r_i, d): MLP([r_i * m_i, m_i, conditioning]) -> (mu,
    logvar[, off]); item_feat_dim 0 is the mean-field encoder, chol=True
    widens the head by the Cholesky entries (zero bias: training starts in
    the diagonal family)."""
    return init_mlp([2 * num_items + item_feat_dim, hidden_dim, hidden_dim,
                     ability_head_dim(ability_dim, chol)], generator, device)


def split_ability_head(out, ability_dim: int | None = None, axis: int = -1):
    """Head output -> (mu, logvar clipped to [-8, 8], off or None).
    ability_dim None: the (mu, logvar) halves along `axis` (0 for the
    (2K, B) head), off None; else [mu (K), logvar (K), off (K(K-1)/2)]."""
    if ability_dim is None:
        mu, logvar = torch.chunk(out, 2, dim=axis)
        return mu, logvar.clamp(-8.0, 8.0), None
    k = ability_dim
    mu = out.narrow(axis, 0, k)
    logvar = out.narrow(axis, k, k)
    off = out.narrow(axis, 2 * k, out.shape[axis] - 2 * k)
    return mu, logvar.clamp(-8.0, 8.0), (off if off.shape[axis] else None)


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
                          compute_dtype="float32",
                          ability_dim: int | None = None, cond_mats=None):
    """Dense encoder on response/mask (B, M): MLP([r*m, m, item_feats]) with
    the concat split into per-block matmuls -> (mu, logvar, off), (B, K)
    each (split_ability_head). cond_mats: (A_r, A_m) of
    condition_stat_mats (condition_on="stats"), which modulate the first
    layer's weight blocks (modulated_first_layer) instead of a flat
    item_feats; with a leading sample axis (S, M, F) the output gets it
    too."""
    cd = as_dtype(compute_dtype)
    w1, rest = params[0], params[1:]
    m = response.shape[-1]
    w_r, w_m = modulated_first_layer(w1, cond_mats, m)
    h = _mm(response * mask, w_r, cd) + _mm(mask, w_m, cd)
    x = _hidden_layers(w1, rest, h, m, item_feats, cd)
    return split_ability_head(x @ rest[-1]["w"] + rest[-1]["b"], ability_dim)


def apply_ability_encoder_packed(params, packed, item_feats=None,
                                 compute_dtype="float32",
                                 transposed_head: bool = False,
                                 ability_dim: int | None = None,
                                 cond_mats=None, decoded=None):
    """apply_ability_encoder on the int8 code: the first layer runs the
    fused decode + dual matmul (`pallas_encoder.packed_first_layer`) on the
    raw weight blocks.

    cond_mats (condition_on="stats"): the kernel's output gets the
    conditioning as the narrow correction (rm @ A_r) @ Wf_r + (m @ A_m) @
    Wf_m (== rm @ (A_r Wf_r) + m @ (A_m Wf_m)), plain products on the
    decoded code, as JAX adds it outside its Pallas kernel; decoded: the
    (mask, resp) of decode_packed(packed) where the caller has them.

    transposed_head=True returns (mu, logvar) as (K, B) from W^T @ x^T,
    the layout the transposed loglik consumes. item_feats (S, F) or
    cond_mats with a leading sample axis give every output that axis
    ((S, B, K), transposed (S, K, B)), the first layer's kernel still
    running once on the code."""
    cd = as_dtype(compute_dtype)
    w1, rest = params[0], params[1:]
    m = packed.shape[-1]
    h = pallas_encoder.packed_first_layer(packed, w1["w"][:m],
                                          w1["w"][m:2 * m], cd)
    if cond_mats is not None:
        a_r, a_m = cond_mats
        fr = a_r.shape[-1]
        wf = w1["w"][2 * m:]
        mk, rm = decoded if decoded is not None else decode_packed(packed)
        h = (h + _mm(_mm(rm, a_r, cd), wf[:fr], cd)
             + _mm(_mm(mk, a_m, cd), wf[fr:], cd))
    x = _hidden_layers(w1, rest, h, m, item_feats, cd)
    if transposed_head:
        out_t = rest[-1]["w"].T @ x.transpose(-1, -2) + rest[-1]["b"][:, None]
        return split_ability_head(out_t, ability_dim, axis=-2)
    return split_ability_head(x @ rest[-1]["w"] + rest[-1]["b"], ability_dim)


def apply_ability_encoder_item_sharded(params, response, mask, item_sample,
                                       num_items_total: int, item_index: int,
                                       group, compute_dtype="float32",
                                       ability_dim: int | None = None,
                                       cond_mats=None):
    """The dense encoder on a 2D mesh tile: response/mask (B, M_l) are the
    columns [item_index * M_l, (item_index + 1) * M_l) of the rank's rows.
    The first layer, a contraction over items, runs as this tile's partial
    products against the matching rows of W1 (at off and at
    num_items_total + off) and of each item head's feature block, summed
    over the items group (psum); the hidden layers and the head then run
    replicated. The same math as apply_ability_encoder on the whole row.

    item_sample: {name: (M_l, D)} the tile's block of the conditioning
    ("sample"/"mean"), or None (mean-field, or "stats"). cond_mats: the
    tile's (A_r, A_m) blocks of condition_stat_mats(local draw, num_items=
    GLOBAL M), which modulate this tile's weight rows, so the psum adds up
    the global statistics' modulation. A leading sample axis on either
    ((S, M_l, D), (S, M_l, F)) gives the outputs that axis."""
    cd = as_dtype(compute_dtype)
    w1, rest = params[0], params[1:]
    m_l = response.shape[-1]
    off = item_index * m_l
    w_r = w1["w"][off:off + m_l]
    w_m = w1["w"][num_items_total + off:num_items_total + off + m_l]
    if cond_mats is not None:
        if item_sample is not None:
            raise ValueError("cond_mats and item_sample are exclusive")
        a_r, a_m = cond_mats
        fr = a_r.shape[-1]
        wf = w1["w"][2 * num_items_total:]
        w_r = w_r + a_r @ wf[:fr]
        w_m = w_m + a_m @ wf[fr:]
    h = _mm(response * mask, w_r, cd) + _mm(mask, w_m, cd)
    if item_sample is not None:
        # flatten_item_sample's layout: sorted names, each an item-major
        # (M * D,) block from 2M plus the earlier blocks
        base = 2 * num_items_total
        for name in sorted(item_sample):
            x = item_sample[name]                      # ([S,] M_l, D)
            d = x.shape[-1]
            w_f = w1["w"][base + off * d:base + (off + m_l) * d]
            h = h + _mm(x.reshape(x.shape[:-2] + (-1,)), w_f,
                        cd)[..., None, :]
            base += num_items_total * d
    h = psum(h, group)
    x = torch.relu(h + w1["b"])
    for layer in rest[:-1]:
        x = torch.relu(_mm(x, layer["w"], cd) + layer["b"])
    return split_ability_head(x @ rest[-1]["w"] + rest[-1]["b"], ability_dim)


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


# ---------------------------- compressed (sufficient-statistic) conditioning


def condition_stat_dim(irt_model: str, ability_dim: int,
                       item_latent_dim: int = 0) -> tuple[int, int]:
    """(Fr, Fm): widths of condition_stat_mats' r-path and m-path
    statistics; the encoder's input under condition_on="stats" is 2M + Fr
    + Fm wide (25 at K = 4 2PL)."""
    k = ability_dim
    if irt_model == "deep":
        return item_latent_dim, item_latent_dim
    if irt_model == "1pl":
        return 1, 2                            # [b] | [b, b^2]
    fr = k + 1 + (1 if irt_model == "3pl" else 0)
    fm = (k + 1) + k + 1 + (k * (k + 1)) // 2 \
        + (1 if irt_model == "3pl" else 0)
    return fr, fm


def condition_stat_mats(item_sample: dict, num_items: int, irt_model: str):
    """Per-item (A_r (..., M, Fr), A_m (..., M, Fm)) such that [(r*m) @
    A_r, m @ A_m] are the 2PL pseudo-posterior's sufficient statistics of
    the item draw: sum_j m r a_j, sum_j m a_j, sum_j m a_j b_j, the pair
    terms sum_j m a_j a_j^T and so on (3PL adds g_hat; grm/gpcm reduce b to
    the mean ordered cutpoint / mean step; deep uses d), scaled by
    1/sqrt(M). They enter as a modulation of the first layer's weights
    (modulated_first_layer); gradients flow to the item posterior through
    them."""
    s = float(1.0 / torch.sqrt(torch.tensor(float(num_items))))  # f32
    if irt_model == "deep":
        d = item_sample["d"]
        return s * d, s * d
    b = item_sample["b"]                                       # (..., M, 1)
    if b.shape[-1] > 1:
        b = (links.grm_thresholds(b).mean(-1, keepdim=True)
             if irt_model == "grm" else b.mean(-1, keepdim=True))
    if irt_model == "1pl":
        return s * b, s * torch.cat([b, b * b], -1)
    a = item_sample["a"]                                       # (..., M, K)
    k = a.shape[-1]
    pairs = [a[..., i:i + 1] * a[..., j:j + 1]
             for i in range(k) for j in range(i, k)]
    r_parts = [a, b]
    m_parts = [a, b, a * b, b * b] + pairs
    if irt_model == "3pl":
        g = item_sample["g_hat"]
        r_parts.append(g)
        m_parts.append(g)
    return s * torch.cat(r_parts, -1), s * torch.cat(m_parts, -1)


def modulated_first_layer(w1: dict, cond_mats, num_items: int):
    """(W_r + A_r @ Wf_r, W_m + A_m @ Wf_m), each (..., M, H): the
    conditioning statistics composed into the first layer's weight blocks
    (f32 products, as in JAX); cond_mats None gives the raw blocks."""
    m = num_items
    w_r, w_m = w1["w"][:m], w1["w"][m:2 * m]
    if cond_mats is None:
        return w_r, w_m
    a_r, a_m = cond_mats
    fr = a_r.shape[-1]
    wf = w1["w"][2 * m:]
    return w_r + a_r @ wf[:fr], w_m + a_m @ wf[fr:]


# ------------------------------------------------ amortized item encoder

ITEM_STAT_DIM = 6


def item_stats(response, mask, num_persons=None, group=None,
               item_group=None):
    """Permutation-invariant per-item column statistics (M, 6) of a (B, M)
    masked response matrix, in f32: the item p-value, the respondents' mean
    raw score, the item-total covariance and point-biserial correlation,
    the observed fraction (of num_persons, default B) and log(1 + count).
    The amortized item encoder's input; any number of persons or items.

    group: the students group of a mesh whose ranks hold student rows: the
    column partial sums are summed over it, and B counts every rank's rows,
    so the statistics are global. item_group: on a 2D mesh a rank holds an
    item block of each row, so the per-person raw score's count and sum are
    summed over the items group too (JAX's axis_name / item_axis_name)."""
    m = mask.float()
    r = response.float() * m
    row_cnt = m.sum(-1, keepdim=True)
    row_sum = r.sum(-1, keepdim=True)
    if item_group is not None:
        row_cnt, row_sum = psum(torch.stack([row_cnt, row_sum]),
                                item_group)
    s = row_sum / torch.clamp_min(row_cnt, 1.0)                 # (B, 1)
    partial = torch.stack([r.sum(-2), m.sum(-2), (s * m).sum(-2),
                           (s * r).sum(-2), (s * s * m).sum(-2)])
    n_local = float(mask.shape[-2])
    if group is not None:
        partial = psum(partial, group)
        n_local *= group_size(group)
    succ, cnt, s_sum, rs_sum, ss_sum = partial
    if num_persons is None:
        num_persons = n_local
    denom = torch.clamp_min(cnt, 1.0)
    p = succ / denom
    ms = s_sum / denom
    rs = rs_sum / denom
    ss = ss_sum / denom
    cov = rs - p * ms
    var_s = torch.clamp_min(ss - ms * ms, 0.0)
    corr = cov * torch.rsqrt(var_s * torch.clamp_min(p * (1.0 - p), 1e-6)
                             + 1e-6)
    frac = cnt / max(float(num_persons), 1.0)
    return torch.stack([p, ms, cov, corr, frac, torch.log1p(cnt)], -1)


def init_item_encoder(irt_model: str, ability_dim: int,
                      generator: torch.Generator, device,
                      item_latent_dim: int = 0, hidden_dim: int = 64,
                      num_categories: int = 2) -> list:
    """q(d_j | r_:,j): MLP from an item's column statistics to (mu, logvar)
    of every item parameter. The output bias starts a's mu at 1.0 and every
    logvar at -2 (init_item_posterior's), so theta is identified from the
    first step."""
    spec = item_head_spec(irt_model, ability_dim, item_latent_dim,
                          num_categories)
    total = sum(spec.values())
    params = init_mlp([ITEM_STAT_DIM, hidden_dim, hidden_dim, 2 * total],
                      generator, device)
    bias = torch.zeros((2 * total,), device=device)
    off = 0
    for name in sorted(spec):
        d = spec[name]
        if name == "a":
            bias[off:off + d] = 1.0
        bias[total + off:total + off + d] = -2.0
        off += d
    params[-1]["b"] = bias
    return params


def init_item_residual(num_items: int, irt_model: str, ability_dim: int,
                       generator: torch.Generator, device,
                       item_latent_dim: int = 0,
                       num_categories: int = 2) -> dict:
    """Free per-item residuals added to the amortized posterior of the
    TRAINING items (semi-amortized: a shared encoder alone cannot break the
    theta-a symmetry); mu ~ 0.1 N(0, 1), logvar 0. New items have none."""
    spec = item_head_spec(irt_model, ability_dim, item_latent_dim,
                          num_categories)
    return {name: {"mu": 0.1 * torch.randn((num_items, spec[name]),
                                           generator=generator,
                                           device=device),
                   "logvar": torch.zeros((num_items, spec[name]),
                                         device=device)}
            for name in sorted(spec)}


def apply_item_encoder(params, stats, spec: dict, residual: dict | None = None
                       ) -> dict:
    """stats (M, 6) -> {name: {'mu', 'logvar': (M, D)}} in sorted-key
    order, f32; residual (the training items') added, logvar clipped to
    [-8, 8]; residual None scores new items by the shared encoder alone."""
    x = stats
    for layer in params[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    out = x @ params[-1]["w"] + params[-1]["b"]            # (M, 2 * total)
    total = out.shape[-1] // 2
    post, off = {}, 0
    for name in sorted(spec):
        d = spec[name]
        mu = out[..., off:off + d]
        logvar = out[..., total + off:total + off + d]
        if residual is not None:
            mu = mu + residual[name]["mu"]
            logvar = logvar + residual[name]["logvar"]
        post[name] = {"mu": mu, "logvar": logvar.clamp(-8.0, 8.0)}
        off += d
    return post


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
