"""Checkpoints and exact resume (counterpart of `vibo_tpu.train.checkpoint`):
one .npz of a state tree's leaves, the torch.Generator's state (in place of
JAX's key), the step and extra_* metadata.

The state a Trainer saves is `train_state(params, optimizer)`: (the param
tree, one {"exp_avg", "exp_avg_sq", "step"} a param leaf). Leaves are
stored as leaf_0, leaf_1, ... in `tree_leaves` order, so the params come
first and in the order of the JAX package's leaves: a JAX Trainer
checkpoint's params, (params, opt_state)'s first leaves, read the same way
(`load_params`). A structure fingerprint of the
tree's paths, shapes and dtypes is stored and checked at load. Only the
params cross from a JAX checkpoint: its PRNG key cannot become a torch
generator, so a JAX checkpoint cannot be resumed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from vibo_tpu_torch.convert import tree_leaves

_GENERATOR = "_generator"      # the port's key; JAX's files hold "_key"


def _paths(tree, prefix: str = "") -> list:
    """Each leaf's path, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def _structure_fingerprint(tree) -> str:
    desc = ",".join(f"{p}{tuple(x.shape)}{x.dtype}"
                    for p, x in zip(_paths(tree), tree_leaves(tree)))
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def _unflatten(template, leaves: list):
    """The tree of `template`'s structure holding `leaves` (tree_leaves
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(template)


def adam_state(params: dict, optimizer) -> list:
    """Adam's state a param leaf ({"exp_avg", "exp_avg_sq", "step"}), its
    fresh zeros where the optimizer has none yet (the step on the param's
    device when Adam is capturable, else on the CPU, where torch.optim
    keeps it)."""
    out = []
    for p in tree_leaves(params):
        st = optimizer.state.get(p)
        if st:
            out.append({k: st[k] for k in ("exp_avg", "exp_avg_sq", "step")})
            continue
        capturable = optimizer.param_groups[0]["capturable"]
        out.append({"exp_avg": torch.zeros_like(p.detach()),
                    "exp_avg_sq": torch.zeros_like(p.detach()),
                    "step": torch.zeros((), dtype=torch.float32,
                                        device=p.device if capturable
                                        else "cpu")})
    return out


def train_state(params: dict, optimizer) -> tuple:
    """The tree a Trainer checkpoint holds: (params, Adam's state)."""
    return (params, adam_state(params, optimizer))


def restore_train_state(state: tuple, params: dict, optimizer) -> None:
    """Put a loaded train_state into `params` (in place, the tensors keep
    their addresses) and `optimizer` (its state replaced)."""
    loaded, adam = state
    with torch.no_grad():
        for p, v in zip(tree_leaves(params), tree_leaves(loaded)):
            p.copy_(v)
    for p, st in zip(tree_leaves(params), adam):
        optimizer.state[p] = {k: st[k].clone() for k in ("step", "exp_avg",
                                                         "exp_avg_sq")}


def save_checkpoint(path: str, state, generator: torch.Generator, step: int,
                    extra: dict | None = None) -> None:
    """state: a tree of tensors (e.g. train_state(params, optimizer))."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy()
              for i, x in enumerate(tree_leaves(state))}
    arrays[_GENERATOR] = generator.get_state().numpy()
    arrays["_step"] = np.asarray(step)
    arrays["_fingerprint"] = np.frombuffer(
        _structure_fingerprint(state).encode(), dtype=np.uint8)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_checkpoint(path: str, state_template):
    """Returns (state, generator_state, step, extra). The template (e.g. a
    fresh train_state) gives the structure; each loaded leaf takes its
    template leaf's device, dtype and requires_grad."""
    with np.load(path) as data:
        if _GENERATOR not in data.files:
            raise ValueError(
                f"{path} is not a checkpoint of this package (a JAX "
                "checkpoint's key cannot be resumed; load_params reads its "
                "params)")
        fp_saved = bytes(data["_fingerprint"]).decode()
        fp_now = _structure_fingerprint(state_template)
        if fp_saved != fp_now:
            raise ValueError(
                f"checkpoint structure mismatch: saved {fp_saved}, template "
                f"{fp_now} (did the model/optimizer config change?)")
        leaves = [torch.as_tensor(data[f"leaf_{i}"]).to(
                      device=t.device, dtype=t.dtype).requires_grad_(
                      t.requires_grad)
                  for i, t in enumerate(tree_leaves(state_template))]
        gen_state = torch.from_numpy(data[_GENERATOR].copy())
        step = int(data["_step"])
        extra = {k[len("extra_"):]: data[k] for k in data.files
                 if k.startswith("extra_")}
    return _unflatten(state_template, leaves), gen_state, step, extra


def peek_extra(path: str) -> dict:
    """Only the extra_* metadata (no template needed)."""
    with np.load(path) as data:
        return {k[len("extra_"):]: data[k] for k in data.files
                if k.startswith("extra_")}


def config_from_json(model_cfg) -> "VIBOConfig":
    """The VIBOConfig of a checkpoint's embedded model config (either
    package's: the two configs have the same fields)."""
    from vibo_tpu_torch.models.vibo import VIBOConfig
    return VIBOConfig(**json.loads(str(model_cfg)))


def load_params(path: str, model) -> dict:
    """`model`'s params from a Trainer checkpoint of either package: the
    first leaves of the stored state, one a leaf of model.init_params in
    tree_leaves order, each shape checked (the port's checkpoints are also
    held to their fingerprint)."""
    from vibo_tpu_torch.train.trainer import make_optimizer
    params = model.init_params(0)
    with np.load(path) as data:
        ours = _GENERATOR in data.files
    if ours:
        template = train_state(params, make_optimizer(params, 5e-3))
        return load_checkpoint(path, template)[0][0]
    leaves = tree_leaves(params)
    with np.load(path) as data:
        for i, t in enumerate(leaves):
            name = f"leaf_{i}"
            if name not in data.files or data[name].shape != tuple(t.shape):
                raise ValueError(
                    f"{path}: {name} is "
                    f"{data[name].shape if name in data.files else 'missing'}"
                    f", the model's param leaf {i} is {tuple(t.shape)} (the "
                    "embedded model config does not describe these params)")
        out = [torch.tensor(data[f"leaf_{i}"], dtype=t.dtype,
                            device=t.device, requires_grad=True)
               for i, t in enumerate(leaves)]
    return _unflatten(params, out)


def load_params_self_describing(path: str, device=None) -> dict:
    """Params of a Trainer checkpoint (either package's), its embedded
    model config giving the template: no caller-side model."""
    from vibo_tpu_torch.models.vibo import VIBO
    extra = peek_extra(path)
    if "model_cfg" not in extra:
        raise ValueError(f"{path} has no embedded model config; it cannot "
                         "be loaded without a template")
    return load_params(path, VIBO(config_from_json(extra["model_cfg"]),
                                  device=device))


_TRANSPLANT_MUST_MATCH = ("num_items", "irt_model", "num_categories",
                          "ability_dim", "hidden_dim", "item_latent_dim",
                          "deep_hidden_dim", "item_encoder",
                          "item_encoder_hidden")


def check_transplant_compat(src_cfg: dict, dst_cfg) -> None:
    """Raise unless warm-starting `dst_cfg` from a checkpoint with embedded
    config `src_cfg` is a documented transplant: the same family,
    mean-field -> conditional, diag -> chol, or condition_on 'sample' <->
    'mean'. Everything else (an ability_dim change would corner-embed the
    source's logvar column into the target's mu block) raises before any
    parameter is touched."""
    dst = {f.name: getattr(dst_cfg, f.name)
           for f in dataclasses.fields(type(dst_cfg))}
    for name in _TRANSPLANT_MUST_MATCH:
        if name in src_cfg and name in dst and src_cfg[name] != dst[name]:
            raise ValueError(
                f"warm-start config mismatch: {name}={src_cfg[name]!r} in "
                f"the source checkpoint vs {dst[name]!r} in the target "
                "model; transplant supports only the documented family "
                "widenings (mean-field -> conditional, diag -> chol), not "
                "architecture changes")
    if (src_cfg.get("conditional_posterior", True)
            and not dst["conditional_posterior"]):
        raise ValueError(
            "warm-start cannot narrow conditional -> mean-field q(theta)")
    if (src_cfg.get("theta_posterior", "diag") == "chol"
            and dst["theta_posterior"] == "diag"):
        raise ValueError("warm-start cannot narrow chol -> diag q(theta)")
    src_tp = src_cfg.get("theta_posterior", "diag")
    dst_tp = dst["theta_posterior"]
    if (src_tp.startswith("laplace") or dst_tp.startswith("laplace")) \
            and src_tp != dst_tp:
        raise ValueError(
            f"warm-start theta_posterior {src_tp!r} -> {dst_tp!r}: the "
            "Fisher-anchored families' c-block is not interchangeable with "
            "logvar/chol heads (same shape, different semantics)")
    if src_cfg.get("conditional_posterior", True) \
            and dst["conditional_posterior"]:
        s, d = src_cfg.get("condition_on", "sample"), dst["condition_on"]
        if s != d and "stats" in (s, d):
            raise ValueError(
                f"warm-start condition_on {s!r} -> {d!r}: the 'stats' "
                "encoder input layout is incompatible with the item-draw "
                "layouts (only 'sample' <-> 'mean' share shapes and "
                "semantics)")


def _embed_leaf(s: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    s = s.detach().to(device=d.device, dtype=d.dtype)
    if s.shape == d.shape:
        return s.clone().requires_grad_(d.requires_grad)
    if s.dim() != d.dim() or any(a > b for a, b in zip(s.shape, d.shape)):
        raise ValueError(
            f"cannot transplant a {tuple(s.shape)} leaf into "
            f"{tuple(d.shape)}: the target family must be at least as wide "
            "as the source in every dim")
    out = torch.zeros_like(d.detach())
    out[tuple(slice(0, n) for n in s.shape)] = s
    return out.requires_grad_(d.requires_grad)


def transplant_params(src: dict, dst: dict) -> dict:
    """Corner-embed every `src` leaf into zeros of the matching `dst`
    leaf's shape (same tree structure): a wider variational family
    warm-started from a trained narrower one. Every supported widening
    appends its slots after the source block (mean-field -> conditional:
    the encoder's first layer grows input rows after the 2M response
    block, and zero rows add nothing), so the transplanted model computes
    the source's function at step 0; equal shapes copy exactly."""
    src_leaves, dst_leaves = tree_leaves(src), tree_leaves(dst)
    if _paths(src) != _paths(dst):
        raise ValueError(
            "warm-start transplant failed: source and target models must "
            "share the param tree's structure (same irt_model/hidden layout)")
    try:
        out = [_embed_leaf(s, d) for s, d in zip(src_leaves, dst_leaves)]
    except ValueError as e:
        raise ValueError(
            f"warm-start transplant failed: {e} (source and target models "
            "must share the param tree's structure — same irt_model/hidden "
            "layout)") from e
    return _unflatten(dst, out)
