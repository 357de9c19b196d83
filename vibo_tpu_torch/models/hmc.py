"""HMC baseline, fixed trajectories and NUTS: the gold posterior over
abilities and item parameters (counterpart of `vibo_tpu.models.hmc`, same
names).

The sampler of arXiv:2002.00276 sections 6.4-6.5, as the JAX package builds
it: the joint potential U(theta, items) = -[masked loglik + N(0, I)
log-priors], referenced per person to the MAP loglik and evaluated in
whitened coordinates q = MAP + Fisher_sd * x; leapfrog with the (U, grad)
pair cached across Metropolis steps (num_leapfrog evaluations a
trajectory) and step-size jitter, or dynamic-length NUTS
(`trajectory="nuts"`: iterative multinomial trees with the checkpoints of
Phan & Pradhan, arXiv:1912.11554); dual averaging pooled over the chains;
Stan-style expanding variance windows pooled over the chains;
Metropolis-within-Gibbs sweeps along the link's likelihood-null ridges and
a Haar rotation move for K > 1; per-draw Procrustes alignment, split-R-hat
and bulk ESS. `irt_model="deep"` samples (theta, d) under a trained deep
decoder with its weights fixed.

Every state tensor carries a leading chain axis C: the chains run batched
(one launch a chain of each kernel). A chain program is a function on
tensors; `step_with_noise` takes its draws as tensors (the momentum z per
name in sorted order; the jitter and accept uniforms, or NUTS's fixed-size
table of uniforms; the ridge draws (R, K, 4): normal, uniform, normal,
uniform per move and dimension, and the rotation's (K, K) Gaussian), and
`step` draws them from an explicit torch.Generator seeded from cfg.seed. The potentials: on the card the
(B, K) one-pass kernels for 1pl/2pl/3pl (rows 4 and 9 of the kernel
table); dense PyTorch for grm/gpcm/deep unless use_packed_kernel=True
(then csrc/loglik_grm.cu, loglik_gpcm.cu and, for the deep link, the f32
kernel csrc/deep_link_f32.cu, split-bf16 products on the tensor cores at
H = 128); dense everywhere on the CPU, as JAX off its TPU. f32 products
run at full precision (TF32 off, `resolve_device`), the
counterpart of JAX's matmul precision "highest".

NUTS runs the chains batched as JAX's vmap of its while loops does: a
chain that has stopped keeps its state through torch.where. Each leaf is
one potential evaluation of every chain and a function of fixed shape
(state, draws, depth, leaf index). The eager draw (`nuts_draw`, what
`step` runs) loops on the host over the tree depths while any chain is
still doubling and, within a depth, over the subtree's leaves while any
chain's subtree is still growing (one host sync a leaf).

`run_hmc` runs its chunks through a `Sampler`, JAX's `run_chunk`: the
state, the warm-up flags' table and the outputs live on the device and
every iteration updates them in place. On the card an iteration is
replayed from CUDA graphs: a fixed trajectory's is one graph (no host sync
in a chunk); a NUTS draw's are a graph for its start, one for each depth's
whole subtree of leaves (the chains masked as they stop, so the leaves
past the last chain's stop run too) and one for each depth's merge, with
one host sync a depth. A failed capture or replay raises; on the CPU the
same bodies run eagerly, and both give the eager steps' values bit for
bit. The MAP init's Adam steps (`_adam_map`) run eagerly on both devices:
they make no host sync, and a graph replayed once would only add its
capture (timed on the card, PERF.md).
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import torch

from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.models import networks
from vibo_tpu_torch.ops import (_build, likelihood as lik, links,
                                pallas_deep, pallas_elbo, pallas_gpcm,
                                pallas_grm)
from vibo_tpu_torch.ops.packing import pack_responses

# what the sampler did since reset_counts(), the launch and sync accounting
# of a run: potential evaluations (each of every chain at once; a graph's at
# each replay), of them those of the graphs' eager warm-up; host syncs of the
# NUTS loops; NUTS leaves run by the draws (not the warm-up's), and those
# the eager loop runs (one sync a leaf, stopping when no chain's subtree
# grows)
_COUNTS = {"evaluations": 0, "warmup_evaluations": 0, "syncs": 0,
           "leaves": 0, "leaves_needed": 0}
# an iteration's outputs (NUTS adds "depth"), in JAX's order
OUT_KEYS = ("pos", "accept", "divergent", "eps", "dh", "steps")


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def counts() -> dict:
    return dict(_COUNTS)


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    irt_model: str = "2pl"             # 1pl | 2pl | 3pl | grm | gpcm | deep
                                       # (deep: pass deep_params to run_hmc)
    ability_dim: int = 1
    num_categories: int = 2            # grm/gpcm: b holds the C-1
                                       # unconstrained table coordinates
    deep_latent_dim: int = 0           # deep only; filled by run_hmc from
    deep_hidden_dim: int = 0           # deep_params' shapes
    num_warmup: int = 300
    num_samples: int = 300
    num_leapfrog: int = 20             # trajectory="fixed" only
    trajectory: str = "fixed"          # "fixed" | "nuts"
    max_tree_depth: int = 8            # nuts: doublings a draw (at most
                                       # 2^depth - 1 evaluations)
    target_accept: float = 0.8
    init_step_size: float = 0.05
    seed: int = 0
    thin: int = 1
    num_chains: int = 4                # >= 2 enables split-R-hat
    adapt_mass: bool = True            # diagonal mass adaptation in warmup
    init_mode: str = "map"             # "map" | "prior"
    map_init_steps: int = 400          # Adam steps for the "map" init
    init_overdispersion: float = 2.0   # chain spread, posterior-sd units
    use_packed_kernel: bool | None = None
                                       # potential via the one-pass kernels;
                                       # None = on the card for the binary
                                       # links only (JAX's choice on TPU)
    scan_chunk: int = 100              # chain iterations per host fetch
                                       # (fixed trajectories past 64
                                       # leapfrogs shrink it in proportion)
    ridge_moves: int = 8               # Gibbs sweeps along the ridges an
                                       # iteration; 0 disables


def _flatten_spec(n, m, cfg):
    if cfg.irt_model == "deep":
        return {"theta": (n, cfg.ability_dim), "d": (m, cfg.deep_latent_dim)}
    if cfg.irt_model in ("grm", "gpcm"):
        return {"theta": (n, cfg.ability_dim), "a": (m, cfg.ability_dim),
                "b": (m, cfg.num_categories - 1)}
    spec = {"theta": (n, cfg.ability_dim), "b": (m,)}
    if cfg.irt_model in ("2pl", "3pl"):
        spec["a"] = (m, cfg.ability_dim)
    if cfg.irt_model == "3pl":
        spec["g_hat"] = (m,)
    return spec


def _prior(params: dict) -> torch.Tensor:
    """0.5 |q|^2 over every parameter: a scalar, or (C,) when the params
    carry the chain axis (theta (C, N, K))."""
    lead = 1 if params["theta"].ndim == 3 else 0
    return sum(0.5 * params[k].square().flatten(lead).sum(-1)
               for k in sorted(params))


def make_potential(resp, mask, cfg: HMCConfig, packed=None, ll_ref=None,
                   deep_params=None):
    """U(params) = -log p(r, theta, d) with standard-normal priors: a
    scalar, or (C,) for params with a leading chain axis.

    packed: the int8 response code (`pack_responses`) for the one-pass
    kernels (value and every gradient in one pass; U consumes -ll.sum(),
    so their uniform-cotangent contract holds per chain). ll_ref: an (N,)
    per-person reference loglik (the MAP's) subtracted before the sum, a
    constant shift that keeps f32 energy differences resolvable at large
    N x M."""
    per_person = _make_loglik_per_person(resp, mask, cfg, packed, deep_params)

    def u(params):
        ll = per_person(params)
        if ll_ref is not None:
            ll = ll - ll_ref
        return -ll.sum(-1) + _prior(params)
    return u


def _per_person_fn(cfg: HMCConfig, m: int, use_pk: bool):
    """(params, data) -> (N,) masked loglik per person ((C, N) with a chain
    axis), through the one-pass kernels (use_pk) or dense PyTorch; shared
    by the chain programs and make_potential."""
    if cfg.irt_model == "deep":
        if use_pk:
            def per_person(params, data):
                # f32 products: bf16 rounding is a dH noise floor the
                # Metropolis test cannot take
                return pallas_deep.masked_loglik_deep_packed_train(
                    params["theta"], params["d"], data["deep"], data["pk"],
                    f32_dots=True)
            return per_person

        def per_person(params, data):
            logits = networks.apply_deep_link(
                data["deep"], params["theta"], params["d"], item_chunk=256)
            return lik.masked_loglik_per_person(logits, data["resp"],
                                                data["mask"])
        return per_person
    if cfg.irt_model in ("grm", "gpcm"):
        fam = cfg.irt_model
        if use_pk:
            if fam == "grm":
                def per_person(params, data):
                    return pallas_grm.masked_loglik_grm_packed_train(
                        params["theta"], params["a"],
                        links.grm_thresholds(params["b"]), data["pk"])
                return per_person

            def per_person(params, data):
                return pallas_gpcm.masked_loglik_gpcm_packed_train(
                    params["theta"], params["a"],
                    links.gpcm_cumsteps(params["b"]), data["pk"])
            return per_person

        def per_person(params, data):
            return lik.categorical_loglik_per_person(
                fam, links.grm_base(params["theta"], params["a"]),
                links.categorical_table(fam, params["b"]),
                data["resp"], data["mask"])
        return per_person
    if use_pk:
        def per_person(params, data):
            theta = params["theta"]
            if cfg.irt_model == "1pl":
                ones_a = torch.ones((m, cfg.ability_dim), device=theta.device)
                return pallas_elbo.masked_loglik_2pl_packed_train(
                    theta, ones_a, params["b"], data["pk"])
            if cfg.irt_model == "2pl":
                return pallas_elbo.masked_loglik_2pl_packed_train(
                    theta, params["a"], params["b"], data["pk"])
            return pallas_elbo.masked_loglik_3pl_packed_train(
                theta, params["a"], params["b"], params["g_hat"], data["pk"])
        return per_person

    def per_person(params, data):
        theta = params["theta"]
        if cfg.irt_model == "1pl":
            logits = links.logits_1pl(theta, params["b"])
            g_hat = None
        else:
            logits = links.logits_2pl(theta, params["a"], params["b"])
            g_hat = params.get("g_hat") if cfg.irt_model == "3pl" else None
        return lik.masked_loglik_per_person(logits, data["resp"],
                                            data["mask"], g_hat=g_hat)
    return per_person


def _f32(x, device=None) -> torch.Tensor:
    """A numpy array or tensor as an f32 tensor on the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(device)


def _deep_on(deep_params: dict, device) -> dict:
    """The decoder's weights as f32 tensors on the device (numpy or torch
    leaves)."""
    if isinstance(deep_params, dict):
        return {k: _deep_on(v, device) for k, v in deep_params.items()}
    return _f32(deep_params, device).detach()


def _make_loglik_per_person(resp, mask, cfg: HMCConfig, packed=None,
                            deep_params=None):
    """(params) -> (N,) masked loglik per person: _per_person_fn with the
    data closed over (the form make_potential and the tests use)."""
    if packed is not None:
        data = {"pk": packed}
        dev = packed.device
    else:
        data = {"resp": _f32(resp), "mask": _f32(mask)}
        dev = data["resp"].device
    if deep_params is not None:
        data["deep"] = _deep_on(deep_params, dev)
    f = _per_person_fn(cfg, resp.shape[1], packed is not None)
    return lambda params: f(params, data)


def _bc(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain (C,) value shaped to broadcast against like (C, ...)."""
    return v.reshape((-1,) + (1,) * (like.ndim - 1))


def _chain_programs(cfg: HMCConfig, n: int, m: int):
    """The chain programs for cfg (cfg.use_packed_kernel resolved to a
    bool), all data passed as arguments: data {"pk"} or {"resp", "mask"}
    (plus "deep"), and for the whitened programs "center", "scale" (no
    chain axis) and "ll_ref" (N,). A chain state is a dict of tensors with
    a leading chain axis: pos, u, g, log_eps, log_eps_bar, h_bar, t, mu,
    inv_mass, w_mean, w_m2, w_cnt (the JAX carry's fields, in its order)."""
    use_pk = bool(cfg.use_packed_kernel)
    spec = _flatten_spec(n, m, cfg)
    names = sorted(spec)
    do_mass = cfg.adapt_mass and cfg.num_warmup >= 20
    # the deep link's MLP breaks the linear links' exact location/scale/
    # rotation invariances: no ridge to move along
    do_ridge = cfg.ridge_moves > 0 and cfg.irt_model != "deep"
    do_rot = cfg.ability_dim > 1 and cfg.irt_model in ("2pl", "3pl", "grm",
                                                        "gpcm")
    kdim = cfg.ability_dim
    per_person = _per_person_fn(cfg, m, use_pk)

    def to_q(x, data):
        return {k: data["center"][k] + data["scale"][k] * x[k] for k in names}

    def u_plain(params, data):
        return -per_person(params, data).sum(-1) + _prior(params)

    def u_x(x, data):
        q = to_q(x, data)
        ll = per_person(q, data) - data["ll_ref"]
        return -ll.sum(-1) + _prior(q)

    def vg(x, data):
        """(U, {name: dU/dx}) of the whitened potential at x: U (C,) for x
        with a chain axis (the chains' gradients apart), else a scalar."""
        _COUNTS["evaluations"] += 1
        with torch.enable_grad():
            xs = {k: x[k].detach().requires_grad_() for k in names}
            u = u_x(xs, data)
            grads = torch.autograd.grad(u.sum(), [xs[k] for k in names])
        return u.detach(), dict(zip(names, grads))

    def leapfrog(pos, mom, eps, inv_mass, g0, data):
        # g0 is the cached gradient at pos: each trajectory costs exactly
        # num_leapfrog potential evaluations
        e = {k: _bc(eps, pos[k]) for k in names}
        mom = {k: mom[k] - 0.5 * e[k] * g0[k] for k in names}
        for _ in range(cfg.num_leapfrog - 1):
            pos = {k: pos[k] + e[k] * inv_mass[k] * mom[k] for k in names}
            _, g = vg(pos, data)
            mom = {k: mom[k] - e[k] * g[k] for k in names}
        pos = {k: pos[k] + e[k] * inv_mass[k] * mom[k] for k in names}
        u_new, g_new = vg(pos, data)
        mom = {k: mom[k] - 0.5 * e[k] * g_new[k] for k in names}
        return pos, mom, u_new, g_new

    def kinetic(mom, inv_mass):
        return sum(0.5 * (mom[k].square() * inv_mass[k]).flatten(1).sum(-1)
                   for k in names)

    # ---- NUTS (cfg.trajectory == "nuts") -----------------------------------
    # JAX's iterative multinomial NUTS on the flat state (names sorted, each
    # leaf row-major), every chain batched: a chain that has stopped keeps
    # its state through torch.where (never a 0/1 product: a diverged leaf
    # may hold NaN or inf)
    offs = np.cumsum([0] + [int(np.prod(spec[k])) for k in names])
    max_d = max(1, int(cfg.max_tree_depth))
    push_np, check_np = nuts_leaf_masks(max_d)
    tables = {}

    def ravel(tree):
        return torch.cat([tree[k].flatten(1) for k in names], 1)

    def unravel(z):
        return {k: z[:, offs[i]:offs[i + 1]].reshape(
            (z.shape[0],) + spec[k]).contiguous()
            for i, k in enumerate(names)}

    def leaf_tables(dev):
        if dev not in tables:
            tables[dev] = (torch.from_numpy(push_np).to(dev),
                           torch.from_numpy(check_np).to(dev))
        return tables[dev]

    def chains_on(flags) -> int:
        """How many chains' flags hold: the host sync of a loop step."""
        _COUNTS["syncs"] += 1
        return int(flags.sum())

    def nuts_leaf(sub, going, every, step, log_u, push, check, data):
        """One leaf of every chain's subtree: a leapfrog from the subtree's
        end, its multinomial weight and progressive sample (log_u: the log
        of its uniform), the checkpoint push (push: (max_d,) the slot of an
        even leaf, None for an odd one) and the U-turn checks of the
        subtrees it closes (check: (max_d,) their slots, None for an even
        leaf); chains not `going` keep their state (every: all are going,
        so nothing is kept). step: the subtree's constants, h0, im and
        half_im (the kinetic energy's 0.5 M^-1), half_e and e_im (0.5 eps
        and eps M^-1 in the subtree's direction). -> (sub, going)."""
        r = sub["r"] - step["half_e"] * sub["g"]
        z = sub["z"] + step["e_im"] * r
        u, g = vg(unravel(z), data)
        g = ravel(g)
        r = r - step["half_e"] * g
        dh = (u + (r.square() * step["half_im"]).sum(-1)) - step["h0"]
        ok = torch.isfinite(dh)
        diverging = ~ok | (dh > 1000.0)
        log_w = torch.where(ok, -dh, -torch.inf)
        acc = torch.where(ok, torch.clamp(torch.exp(-dh), max=1.0), 0.0)
        # progressive sampling within the subtree: the first leaf (log_w
        # -inf before it) is taken with probability 1, a divergent one never
        lse = torch.logaddexp(sub["log_w"], log_w)
        take = log_u < (log_w - lse)
        rho = sub["rho"] + r
        ck_r, ck_s = sub["ck_r"], sub["ck_s"]
        if push is not None:
            ck_r = torch.where(push[:, None], r[:, None, :], ck_r)
            ck_s = torch.where(push[:, None], rho[:, None, :], ck_s)
        # an even leaf closes no subtree: a going chain has not turned
        turning = sub["turning"]
        if check is not None:
            im = step["im"]
            rho_k = rho[:, None, :] - ck_s + ck_r
            turn_k = (((rho_k * (im[:, None, :] * ck_r)).sum(-1) <= 0.0)
                      | ((rho_k * (im * r)[:, None, :]).sum(-1) <= 0.0))
            turning = (check & turn_k).any(-1)
        new = {"z": z, "r": r, "g": g, "prop_z": _pick(take, z, sub["prop_z"]),
               "prop_u": torch.where(take, u, sub["prop_u"]),
               "prop_g": _pick(take, g, sub["prop_g"]),
               "prop_dh": torch.where(take, dh, sub["prop_dh"]),
               "log_w": lse, "rho": rho, "ck_r": ck_r, "ck_s": ck_s,
               "turning": turning, "diverging": diverging,
               "sum_acc": sub["sum_acc"] + acc, "n_lf": sub["n_lf"] + 1.0}
        if not every:
            new = {k: _pick(going, new[k], sub[k]) for k in sub}
        return new, going & ~(turning | diverging)

    def nuts_begin(state, mom, eps, noise):
        """A draw's constants and its one-leaf tree -> (ctx, st): ctx the
        kinetic energy's h0, im and half_im (`kin`), eps, the doubling
        directions' uniforms and the logs of the merge and leaf uniforms;
        st the tree (both ends, the proposal, the weight, the momentum sum,
        the stop flags and the counts)."""
        z0, r0, g0, im = (ravel(t) for t in (state["pos"], mom, state["g"],
                                             state["inv_mass"]))
        u_cur = state["u"]
        half_im = 0.5 * im
        kin = {"h0": u_cur + (r0.square() * half_im).sum(-1), "im": im,
               "half_im": half_im}
        ctx = {"kin": kin, "eps": eps, "dir": noise["nuts_dir"],
               "log_leaf": torch.log(noise["nuts_leaf"]),
               "log_take": torch.log(noise["nuts_take"])}
        zero = torch.zeros_like(u_cur)
        no = torch.zeros(u_cur.shape, dtype=torch.bool, device=u_cur.device)
        st = {"z_l": z0, "r_l": r0, "g_l": g0, "z_r": z0, "r_r": r0,
              "g_r": g0, "prop_z": z0, "prop_u": u_cur, "prop_g": g0,
              "prop_dh": zero, "log_w": zero, "rho": r0, "turning": no,
              "diverging": no, "sum_acc": zero, "n_lf": zero,
              "depth": zero}
        return ctx, st

    def nuts_active(st):
        """The chains still doubling their tree."""
        return ~(st["turning"] | st["diverging"])

    def nuts_start(st, depth, ctx):
        """A doubling's direction and its empty subtree at the tree's end
        in that direction -> (right, sub, step): step the subtree's
        constants (kin with half_e and e_im, 0.5 eps and eps M^-1 signed by
        the direction)."""
        kin = ctx["kin"]
        right = ctx["dir"][:, depth] < 0.5
        eps_d = torch.where(right, ctx["eps"], -ctx["eps"])
        z, r, g = (_pick(right, st[k + "_r"], st[k + "_l"])
                   for k in ("z", "r", "g"))
        e = eps_d[:, None]
        step = dict(kin, half_e=0.5 * e, e_im=e * kin["im"])
        zero = torch.zeros_like(kin["h0"])
        no = torch.zeros(zero.shape, dtype=torch.bool, device=zero.device)
        ck = z.new_zeros((z.shape[0], max_d, z.shape[1]))
        sub = {"z": z, "r": r, "g": g, "prop_z": z, "prop_u": zero,
               "prop_g": g, "prop_dh": zero,
               "log_w": torch.full_like(zero, -torch.inf),
               "rho": torch.zeros_like(z), "ck_r": ck, "ck_s": ck,
               "turning": no, "diverging": no, "sum_acc": zero,
               "n_lf": zero}
        return right, sub, step

    def nuts_leaves(sub, going, every, step, depth, ctx, data, sync):
        """The leaves of every chain's depth-`depth` subtree, each chain
        stopping at its first turning or diverging leaf. sync: the eager
        form, which reads on the host before each leaf past the first
        whether any chain is still going (and stops the loop, or drops the
        masking while all are); else every leaf runs, masked. -> (sub,
        going)."""
        push_tab, check_tab = leaf_tables(going.device)
        for i in range(1 << depth):
            if sync and i:
                n_going = chains_on(going)
                if not n_going:
                    break
                every = n_going == going.shape[0]
            _COUNTS["leaves"] += 1
            if sync:
                _COUNTS["leaves_needed"] += 1
            sub, going = nuts_leaf(
                sub, going, every, step,
                ctx["log_leaf"][:, (1 << depth) - 1 + i],
                push_tab[i] if push_np[i].any() else None,
                check_tab[i] if check_np[i].any() else None, data)
        return sub, going

    def nuts_merge(st, sub, active, right, depth, every, ctx):
        """Merge a doubling's subtree into every active chain's tree: a
        turning or diverging subtree is discarded whole (its leapfrogs
        still count); the proposal's merge is biased toward the new
        subtree (Betancourt 2017); then the whole tree's U-turn check."""
        im = ctx["kin"]["im"]
        ok = active & ~(sub["turning"] | sub["diverging"])
        take = ok & (ctx["log_take"][:, depth] < (sub["log_w"] - st["log_w"]))
        new = dict(st)
        for k in ("z", "r", "g"):
            new[k + "_r"] = _pick(ok & right, sub[k], st[k + "_r"])
            new[k + "_l"] = _pick(ok & ~right, sub[k], st[k + "_l"])
        new["rho"] = _pick(ok, st["rho"] + sub["rho"], st["rho"])
        new["log_w"] = torch.where(
            ok, torch.logaddexp(st["log_w"], sub["log_w"]), st["log_w"])
        for k in ("prop_z", "prop_u", "prop_g", "prop_dh"):
            new[k] = _pick(take, sub[k], st[k])
        rho, r_l, r_r = new["rho"], new["r_l"], new["r_r"]
        turn = (((rho * im * r_l).sum(-1) <= 0.0)
                | ((rho * im * r_r).sum(-1) <= 0.0))
        new["turning"] = sub["turning"] | (ok & turn)
        new["diverging"] = st["diverging"] | sub["diverging"]
        new["sum_acc"] = st["sum_acc"] + sub["sum_acc"]
        new["n_lf"] = st["n_lf"] + sub["n_lf"]
        new["depth"] = st["depth"] + 1.0
        return new if every else {k: _pick(active, new[k], st[k]) for k in st}

    def nuts_result(st, ctx):
        """The draw's outcome, as the fixed trajectory's (`propose`)."""
        return {"pos": unravel(st["prop_z"]), "u": st["prop_u"],
                "g": unravel(st["prop_g"]),
                "accept": st["sum_acc"] / torch.clamp(st["n_lf"], min=1.0),
                "divergent": st["diverging"].float(), "steps": st["n_lf"],
                "dh": st["prop_dh"], "eps": ctx["eps"], "depth": st["depth"]}

    def nuts_draw(state, mom, eps, noise, data):
        """One dynamic-length draw of every chain, eagerly: the host loops
        over the depths while any chain is doubling and over a subtree's
        leaves while any chain's subtree is growing (one sync a leaf) ->
        nuts_result's dict (the accept statistic, divergent, leapfrogs, dh
        of the selected proposal, tree depth, each with the chain axis)."""
        ctx, st = nuts_begin(state, mom, eps, noise)
        for depth in range(max_d):
            active = nuts_active(st)
            n_active = chains_on(active)
            if not n_active:
                break
            every = n_active == active.shape[0]
            right, sub, step = nuts_start(st, depth, ctx)
            sub, _ = nuts_leaves(sub, active, every, step, depth, ctx, data,
                                 sync=True)
            st = nuts_merge(st, sub, active, right, depth, every, ctx)
        return nuts_result(st, ctx)

    gamma, t0, kappa = 0.05, 10.0, 0.75
    log10 = math.log(10.0)
    sig_s = 2.4 / np.sqrt(2.0 * (n + m))
    sig_c = 2.4 / np.sqrt(1.0 * (n + m))

    def ridge_sweep(theta_q, a_q, b_q, draws, eye):
        """One sweep along the location and scale ridges of every latent
        dimension; draws (C, K, 4): the scale move's normal and uniform,
        the location move's normal and uniform; eye: the (K, K) identity
        (a column update multiplies by 1 or adds 0 elsewhere: exact)."""
        # polytomous b_q (C, M, C-1): the location ridge theta_k += c moves
        # the grm thresholds' first column (the increments are shift-
        # invariant) and every gpcm step column by c a_k
        grm_b = b_q is not None and b_q.ndim == 3
        for kd in range(kdim):
            onehot = eye[kd]
            if a_q is not None:
                sp = sig_s * draws[:, kd, 0]
                st = theta_q[..., kd].square().sum(-1)
                sa = a_q[..., kd].square().sum(-1)
                logr = (-0.5 * ((torch.exp(2 * sp) - 1.0) * st
                                + (torch.exp(-2 * sp) - 1.0) * sa)
                        + (n - m) * sp)
                ok = torch.log(draws[:, kd, 1]) < logr
                es = torch.where(ok, torch.exp(sp), 1.0)
                # x * 1.0 is exact: the other columns stay bitwise
                theta_q = theta_q * (1.0 + onehot * (es[:, None] - 1.0)
                                     )[:, None, :]
                a_q = a_q * (1.0 + onehot * (1.0 / es[:, None] - 1.0)
                             )[:, None, :]
                ak = a_q[..., kd]
            else:
                ak = torch.ones_like(b_q)
            if grm_b and cfg.irt_model == "gpcm":
                b0 = b_q.sum(-1)
                ncols = b_q.shape[-1]
            else:
                b0 = b_q[..., 0] if grm_b else b_q
                ncols = 1
            cp = sig_c * draws[:, kd, 2]
            logr = -0.5 * (2 * cp * theta_q[..., kd].sum(-1)
                           + n * cp * cp
                           + 2 * cp * (b0 * ak).sum(-1)
                           + ncols * cp * cp * ak.square().sum(-1))
            ok = torch.log(draws[:, kd, 3]) < logr
            cc = torch.where(ok, cp, 0.0)
            theta_q = theta_q + (onehot * cc[:, None])[:, None, :]
            shift = cc[:, None] * ak
            if grm_b and cfg.irt_model == "gpcm":
                b_q = b_q + shift[..., None]
            elif grm_b:
                b_q = torch.cat([b_q[..., :1] + shift[..., None],
                                 b_q[..., 1:]], -1)
            else:
                b_q = b_q + shift
        return theta_q, a_q, b_q

    def momentum(state, noise):
        """p ~ N(0, M) with M = 1/inv_mass: p = z / sqrt(inv_mass)."""
        return {k: noise["z"][k] * torch.rsqrt(state["inv_mass"][k])
                for k in names}

    def step_size(state, adapt):
        """The iteration's step: the adapting one in warm-up, else the
        averaged one (adapt a tensor flag, as JAX's jnp.where)."""
        return torch.exp(torch.where(adapt != 0, state["log_eps"],
                                     state["log_eps_bar"]))

    def fixed_draw(state, mom, eps, noise, data):
        """One jittered fixed-length trajectory of every chain and its
        Metropolis test -> the moved chains (pos, u, g) with the accept
        probability, divergent, leapfrogs, dh and the jittered step."""
        pos, u_cur, g_cur = state["pos"], state["u"], state["g"]
        inv_mass = state["inv_mass"]
        # jitter the trajectory length through the step (state-independent:
        # detailed balance holds): a fixed eps L resonates
        eps = eps * (1.0 - noise["jitter"] / 3.0)
        u0 = u_cur + kinetic(mom, inv_mass)
        new_pos, new_mom, u_pot, g_new = leapfrog(pos, mom, eps, inv_mass,
                                                  g_cur, data)
        u1 = u_pot + kinetic(new_mom, inv_mass)
        log_accept = torch.clamp(u0 - u1, max=0.0)
        # a NaN trajectory (divergence) is rejected
        log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                                 -torch.inf)
        accept = torch.log(noise["accept"]) < log_accept
        return {"pos": {k: _pick(accept, new_pos[k], pos[k]) for k in names},
                "u": torch.where(accept, u_pot, u_cur),
                "g": {k: _pick(accept, g_new[k], g_cur[k]) for k in names},
                "accept": torch.exp(log_accept),
                "divergent": 1.0 - torch.isfinite(u1 - u0).float(),
                "steps": torch.full_like(u_cur, float(cfg.num_leapfrog)),
                "dh": u1 - u0, "eps": eps}

    def gibbs(pos, noise, data):
        """Metropolis-within-Gibbs along the likelihood-null ridges (the
        accepts cost prior ratios only), then the exact O(K) rotation
        move; one potential evaluation refreshes the (U, grad) cache ->
        (pos, u, g)."""
        q0 = to_q(pos, data)
        theta_q, a_q, b_q = q0["theta"], q0.get("a"), q0.get("b")
        if do_ridge:
            eye = torch.eye(kdim, device=theta_q.device)
            for r in range(cfg.ridge_moves):
                theta_q, a_q, b_q = ridge_sweep(theta_q, a_q, b_q,
                                                noise["ridge"][:, r], eye)
        if do_rot:
            # R ~ Haar(O(K)): QR of a Gaussian with the R-diagonal sign
            # fix; the posterior is invariant under (theta R, a R)
            qm, rm = torch.linalg.qr(noise["rotation"])
            rot = qm * torch.sign(torch.diagonal(rm, dim1=-2, dim2=-1)
                                  )[:, None, :]
            theta_q = theta_q @ rot
            a_q = a_q @ rot
        q1 = dict(q0)
        q1["theta"] = theta_q
        if b_q is not None:
            q1["b"] = b_q
        if a_q is not None:
            q1["a"] = a_q
        pos = {k: (q1[k] - data["center"][k]) / data["scale"][k]
               for k in names}
        u_cur, g_cur = vg(pos, data)
        return pos, u_cur, g_cur

    def adaptation(state, pos, accept_prob, adapt, collect, switch):
        """The warm-up's step-size and metric state after an iteration,
        its flags tensors applied with torch.where as JAX's jnp.where:
        every update is computed, then selected."""
        log_eps, log_eps_bar = state["log_eps"], state["log_eps_bar"]
        h_bar, t, mu = state["h_bar"], state["t"], state["mu"]
        inv_mass = state["inv_mass"]
        w_mean, w_m2, w_cnt = state["w_mean"], state["w_m2"], state["w_cnt"]
        # dual averaging, its statistic pooled over the chains (JAX's pmean
        # over the vmapped axis); the accept stays per chain
        adapting = adapt != 0
        t = t + adapt
        accept_stat = accept_prob.mean()
        h_bar_new = ((1.0 - 1.0 / (t + t0)) * h_bar
                     + (cfg.target_accept - accept_stat) / (t + t0))
        log_eps_new = mu - torch.sqrt(t) / gamma * h_bar_new
        eta = t ** (-kappa)
        log_eps_bar_new = eta * log_eps_new + (1.0 - eta) * log_eps_bar
        log_eps = torch.where(adapting, log_eps_new, log_eps)
        log_eps_bar = torch.where(adapting, log_eps_bar_new, log_eps_bar)
        h_bar = torch.where(adapting, h_bar_new, h_bar)
        if do_mass:
            # Welford accumulation over the memoryless windows (the flags
            # come from the host's schedule)
            collecting, switching = collect > 0, switch > 0
            w_cnt_new = w_cnt + 1.0
            w_mean_new = {k: w_mean[k] + (pos[k] - w_mean[k])
                          / _bc(w_cnt_new, pos[k]) for k in names}
            w_m2 = {k: torch.where(collecting, w_m2[k] + (pos[k] - w_mean[k])
                                   * (pos[k] - w_mean_new[k]), w_m2[k])
                    for k in names}
            w_mean = {k: torch.where(collecting, w_mean_new[k], w_mean[k])
                      for k in names}
            w_cnt = torch.where(collecting, w_cnt_new, w_cnt)
            denom = torch.clamp(w_cnt - 1.0, min=1.0)
            shrink = w_cnt / (w_cnt + 5.0)

            def new_im(k):
                # the window variances pooled over the chains; shrunk toward
                # the whitened prior metric 1; an almost empty window keeps
                # the old metric
                var = (w_m2[k] / _bc(denom, w_m2[k])).mean(0, keepdim=True)
                sh = _bc(shrink, w_m2[k])
                est = torch.clamp(sh * var + (1.0 - sh), 1e-6, 1e6)
                return torch.where(_bc(w_cnt >= 4.0, w_m2[k]), est,
                                   inv_mass[k])
            inv_mass = {k: torch.where(switching, new_im(k), inv_mass[k])
                        for k in names}
            w_cnt = torch.where(switching, 0.0, w_cnt)
            w_mean = {k: torch.where(switching, 0.0, v)
                      for k, v in w_mean.items()}
            w_m2 = {k: torch.where(switching, 0.0, v) for k, v in w_m2.items()}
            mu = torch.where(switching, log10 + log_eps_bar, mu)
            log_eps = torch.where(switching, log_eps_bar, log_eps)
            h_bar = torch.where(switching, 0.0, h_bar)
            t = torch.where(switching, 0.0, t)
        return {"log_eps": log_eps, "log_eps_bar": log_eps_bar,
                "h_bar": h_bar, "t": t, "mu": mu, "inv_mass": inv_mass,
                "w_mean": w_mean, "w_m2": w_m2, "w_cnt": w_cnt}

    def finish(state, moved, noise, adapt, collect, switch, data):
        """An iteration's end from the moved chains (fixed_draw's or
        nuts_result's dict): the ridge and rotation moves and the
        adaptation -> (state, out)."""
        pos, u_cur, g_cur = moved["pos"], moved["u"], moved["g"]
        if do_ridge or do_rot:
            pos, u_cur, g_cur = gibbs(pos, noise, data)
        state = {"pos": pos, "u": u_cur, "g": g_cur,
                 **adaptation(state, pos, moved["accept"], adapt, collect,
                              switch)}
        out = {"pos": pos, **{k: moved[k] for k in OUT_KEYS[1:]}}
        if "depth" in moved:
            out["depth"] = moved["depth"]
        return state, out

    def flags_of(adapt, collect, switch, like):
        """The warm-up flags as f32 tensors on like's device (numbers or
        tensors: 0-d views of the sampler's flag table)."""
        return tuple(torch.as_tensor(f, dtype=torch.float32,
                                     device=like.device)
                     for f in (adapt, collect, switch))

    def step_with_noise(state, noise, adapt, collect, switch, data):
        """One iteration of every chain on exogenous draws -> (state, out),
        JAX's `step`. noise: {"z": {name: (C, ...)}, "ridge": (C,
        ridge_moves, K, 4), "rotation": (C, K, K)} and, fixed trajectories,
        "jitter" (C,) and "accept" (C,); NUTS, uniforms "nuts_dir" (C,
        max_d) (right where < 0.5), "nuts_take" (C, max_d) (each doubling's
        merge) and "nuts_leaf" (C, 2^max_d - 1) (leaf l of the depth-d
        subtree at 2^d - 1 + l); adapt, collect, switch: this iteration's
        warm-up flags (numbers or 0-d tensors), applied with torch.where,
        so one function serves every iteration of the schedule."""
        adapt, collect, switch = flags_of(adapt, collect, switch, state["u"])
        mom = momentum(state, noise)
        eps = step_size(state, adapt)
        if cfg.trajectory == "nuts":
            # dynamic lengths: no jitter (the random doubling directions and
            # the multinomial selection break resonances)
            moved = nuts_draw(state, mom, eps, noise, data)
        else:
            moved = fixed_draw(state, mom, eps, noise, data)
        return finish(state, moved, noise, adapt, collect, switch, data)

    def draw_noise(generator, chains: int) -> dict:
        """One iteration's draws for `chains` chains from the generator."""
        dev = generator.device

        def normal(shape):
            return torch.randn(shape, generator=generator, device=dev)

        def uniform(shape):
            return torch.rand(shape, generator=generator, device=dev)
        z = {k: normal((chains,) + spec[k]) for k in names}
        ridge = torch.stack([normal((chains, cfg.ridge_moves, kdim)),
                             uniform((chains, cfg.ridge_moves, kdim)),
                             normal((chains, cfg.ridge_moves, kdim)),
                             uniform((chains, cfg.ridge_moves, kdim))], -1)
        if cfg.trajectory == "nuts":
            return {"z": z, "nuts_dir": uniform((chains, max_d)),
                    "nuts_take": uniform((chains, max_d)),
                    "nuts_leaf": uniform((chains, (1 << max_d) - 1)),
                    "ridge": ridge, "rotation": normal((chains, kdim, kdim))}
        return {"z": z, "jitter": uniform((chains,)),
                "accept": uniform((chains,)), "ridge": ridge,
                "rotation": normal((chains, kdim, kdim))}

    def step(state, adapt, collect, switch, data, generator):
        chains = state["u"].shape[0]
        return step_with_noise(state, draw_noise(generator, chains), adapt,
                               collect, switch, data)

    def init_chain(position, data):
        u_init, g_init = vg(position, data)
        chains = u_init.shape[0]
        dev = u_init.device
        log0 = torch.full((chains,), math.log(cfg.init_step_size),
                          device=dev)
        return {"pos": {k: position[k] for k in names}, "u": u_init,
                "g": g_init, "log_eps": log0, "log_eps_bar": log0.clone(),
                "h_bar": torch.zeros(chains, device=dev),
                "t": torch.zeros(chains, device=dev),
                "mu": torch.full((chains,),
                                 math.log(10.0 * cfg.init_step_size),
                                 device=dev),
                "inv_mass": {k: torch.ones_like(position[k]) for k in names},
                "w_mean": {k: torch.zeros_like(position[k]) for k in names},
                "w_m2": {k: torch.zeros_like(position[k]) for k in names},
                "w_cnt": torch.zeros(chains, device=dev)}

    def map_run(params, data):
        """The joint MAP (no chain axis): _adam_map on the unwhitened
        potential from params."""
        return _adam_map(lambda p: u_plain(p, data),
                         {k: params[k] for k in names}, cfg.map_init_steps)

    def ll_ref_fn(params, data):
        with torch.no_grad():
            return per_person(params, data)

    return types.SimpleNamespace(
        cfg=cfg, spec=spec, names=names, max_d=max_d, vg=vg,
        step_with_noise=step_with_noise, draw_noise=draw_noise, step=step,
        init=init_chain, map_run=map_run, ll_ref_fn=ll_ref_fn,
        # the pieces of step_with_noise that the sampler's graphs split
        momentum=momentum, step_size=step_size, fixed_draw=fixed_draw,
        finish=finish, gibbs=gibbs, nuts_draw=nuts_draw,
        nuts_begin=nuts_begin,
        nuts_active=nuts_active, nuts_start=nuts_start,
        nuts_leaves=nuts_leaves, nuts_merge=nuts_merge,
        nuts_result=nuts_result)


def _clone(tree):
    """A copy of a dict tree of tensors."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _assign(dst, src) -> None:
    """Copy a dict tree of tensors into one of the same structure, in place
    (dst keeps its addresses)."""
    if isinstance(dst, dict):
        for k in dst:
            _assign(dst[k], src[k])
    else:
        dst.copy_(src)


class _Graph:
    """One CUDA graph of body(), captured in the memory pool `pool`, with
    the counts (`_COUNTS`) and kernel launches (`_build.recording_captures`)
    its capture made, which every replay adds again: a launch count is the
    launches captured times the replays. generator: registered with the
    graph, so each replay draws anew from it as eager steps would."""

    def __init__(self, body, pool=None, generator=None):
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = dict(_COUNTS)
        with _build.recording_captures() as launched:
            with torch.cuda.graph(graph, pool=pool):
                body()
        self.counts = {k: _COUNTS[k] - before[k] for k in _COUNTS}
        _COUNTS.update(before)
        self.graph, self.launched = graph, launched

    def replay(self) -> None:
        self.graph.replay()
        for k, v in self.counts.items():
            _COUNTS[k] += v
        _build.add_launches(self.launched)


class Sampler:
    """JAX's `run_chunk` (a lax.scan of `step` over a chunk's iterations,
    one device program a dispatch; `vibo_tpu/models/hmc.py` :824-848) for
    the port's chain programs: `run(n)` takes n iterations of every chain
    and returns their outputs in one host fetch.

    The chain state, the outputs' (C, chunk, ...) buffers, the warm-up
    flags' (3, T) table (adapt, collect, switch an iteration) and the
    iteration counter that indexes it all live on the device at fixed
    addresses; an iteration updates them in place and moves the counter
    on. On the card it is replayed from CUDA graphs, captured at the first
    run after one eager pass of their bodies on a side stream whose effects
    are then put back (state, counter, generator): a fixed trajectory is
    one graph, its draws from the generator registered with it, so a chunk
    makes no host sync; NUTS is a graph for the draw's start (its draws),
    one for each depth's whole subtree of leaves (its chains masked as they
    stop) and one for each depth's merge, and the host reads one count
    before each depth (is any chain doubling?). A failed capture or replay
    raises; nothing
    falls back to eager steps. On the CPU the same bodies run eagerly, so
    both give the eager steps' values bit for bit (`step`; NUTS's masked
    leaves equal its per-leaf loop, whose stopped chains keep their state).
    draw: the iteration's noise, by default `draw_noise` from the
    generator; another source (JAX's draws in the tests) on the CPU only."""

    def __init__(self, programs, state: dict, data: dict,
                 generator: torch.Generator, flags, chunk: int, draw=None):
        self.p, self.data, self.gen = programs, data, generator
        self.nuts = programs.cfg.trajectory == "nuts"
        dev = state["u"].device
        if draw is not None and dev.type == "cuda":
            raise ValueError("a Sampler on the card draws from its "
                             "generator (draw= is for the CPU)")
        chains = state["u"].shape[0]
        self.draw = draw or (lambda: programs.draw_noise(generator, chains))
        self.state = _clone(state)
        self.flags = torch.as_tensor(np.asarray(flags, np.float32)).to(dev)
        self.it = torch.zeros(1, dtype=torch.long, device=dev)
        self.slot = torch.zeros(1, dtype=torch.long, device=dev)
        self.chunk = chunk
        lead = (chains, chunk)
        self.out = {"pos": {k: torch.zeros(lead + v, device=dev)
                            for k, v in programs.spec.items()},
                    **{k: torch.zeros(lead, device=dev)
                       for k in OUT_KEYS[1:]}}
        if self.nuts:
            self.out["depth"] = torch.zeros(lead, device=dev)
            self.out["leaves_needed"] = torch.zeros((1, chunk), device=dev)
        self.nt: dict = {}          # NUTS's tensors between its graphs
        self.graphs = None

    # ---- the bodies (eager on the CPU, captured on the card) --------------
    def _flags(self):
        f = self.flags.index_select(1, self.it)[:, 0]
        return f[0], f[1], f[2]

    def _keep(self, name: str, value) -> None:
        """NUTS's tensor `name` at its fixed address (made by the first,
        eager pass; copied into after)."""
        if name in self.nt:
            _assign(self.nt[name], value)
        else:
            self.nt[name] = _clone(value)

    def _record(self, out: dict) -> None:
        """An iteration's outputs into the chunk's buffers at its slot."""
        for k, buf in self.out["pos"].items():
            buf.index_copy_(1, self.slot, out["pos"][k].unsqueeze(1))
        for k in OUT_KEYS[1:] + (("depth",) if self.nuts else ()):
            self.out[k].index_copy_(1, self.slot, out[k].unsqueeze(1))

    def _advance(self, new_state: dict) -> None:
        _assign(self.state, new_state)
        self.it.add_(1)
        self.slot.add_(1)

    def _iteration(self) -> None:
        new, out = self.p.step_with_noise(self.state, self.draw(),
                                          *self._flags(), self.data)
        self._record(out)
        self._advance(new)

    def _begin(self) -> None:
        p, state = self.p, self.state
        noise = self.draw()
        ctx, st = p.nuts_begin(state, p.momentum(state, noise),
                               p.step_size(state, self._flags()[0]), noise)
        # read by the later graphs at these (the begin graph's) addresses
        self.noise, self.ctx = noise, ctx
        self._keep("st", st)
        self._keep("n_on", p.nuts_active(st).sum())
        self._keep("needed", torch.zeros(1, device=st["n_lf"].device))

    def _leaves(self, depth: int) -> None:
        p, nt = self.p, self.nt
        active = p.nuts_active(nt["st"])
        right, sub, step = p.nuts_start(nt["st"], depth, self.ctx)
        sub, _ = p.nuts_leaves(sub, active, False, step, depth, self.ctx,
                               self.data, sync=False)
        self._keep("active", active)
        self._keep("right", right)
        self._keep("sub", sub)

    def _merge(self, depth: int) -> None:
        p, nt = self.p, self.nt
        st = p.nuts_merge(nt["st"], nt["sub"], nt["active"], nt["right"],
                          depth, False, self.ctx)
        # the leaves the eager loop runs at this depth: the most any chain
        # took before it stopped
        nt["needed"].add_(nt["sub"]["n_lf"].max())
        self._keep("st", st)
        self._keep("n_on", p.nuts_active(st).sum())

    def _end(self) -> None:
        nt = self.nt
        new, out = self.p.finish(self.state, self.p.nuts_result(
            nt["st"], self.ctx), self.noise, *self._flags(), self.data)
        self._record(out)
        self.out["leaves_needed"].index_copy_(1, self.slot,
                                              nt["needed"][None])
        self._advance(new)

    def _body(self, key):
        if key == "iteration":
            return self._iteration
        if key == "begin":
            return self._begin
        if key == "end":
            return self._end
        kind, depth = key
        if kind == "leaves":
            return lambda: self._leaves(depth)
        return lambda: self._merge(depth)

    # ---- the host's loop --------------------------------------------------
    def _keys(self, depths: int) -> list:
        """The graphs of an iteration through `depths` tree depths."""
        if not self.nuts:
            return ["iteration"]
        keys = ["begin"]
        for d in range(depths):
            keys += [("leaves", d), ("merge", d)]
        return keys + ["end"]

    def _on(self) -> int:
        """The host sync of the NUTS loop: chains still doubling."""
        _COUNTS["syncs"] += 1
        return int(self.nt["n_on"])

    def _one(self, call) -> None:
        if not self.nuts:
            call("iteration")
            return
        call("begin")
        for depth in range(self.p.max_d):
            if not self._on():
                break
            call(("leaves", depth))
            call(("merge", depth))
        call("end")

    def capture(self) -> None:
        """On the card, capture the graphs (once); on the CPU nothing."""
        if self.graphs is not None or not self.state["u"].is_cuda:
            return
        dev = self.state["u"].device
        saved = (_clone(self.state), self.it.clone(), self.slot.clone(),
                 self.gen.get_state())
        before = dict(_COUNTS)
        with torch.no_grad():
            # one eager pass on a side stream, as a capture wants before it:
            # it loads every kernel and library the graphs will launch and
            # makes cuBLAS's workspace; its effects are put back below
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for key in self._keys(min(2, self.p.max_d)):
                    self._body(key)()
            torch.cuda.current_stream(dev).wait_stream(side)
            # its evaluations launched kernels and stay counted, apart; its
            # leaves were no draw's
            _COUNTS["warmup_evaluations"] += (_COUNTS["evaluations"]
                                              - before["evaluations"])
            _COUNTS["leaves"] = before["leaves"]
            _assign(self.state, saved[0])
            self.it.copy_(saved[1])
            self.slot.copy_(saved[2])
            self.gen.set_state(saved[3])
            pool = torch.cuda.graph_pool_handle()
            self.graphs = {
                key: _Graph(self._body(key), pool,
                            self.gen if key in ("iteration", "begin")
                            else None)
                for key in self._keys(self.p.max_d)}

    def advance(self, n: int) -> None:
        """n (<= chunk) iterations of every chain into the chunk's buffers,
        from its first slot; on the card graph replays (captured at the
        first call), with no host sync but NUTS's counts."""
        if not 0 < n <= self.chunk:
            raise ValueError(f"a run takes 1 to {self.chunk} iterations, "
                             f"got {n}")
        self.capture()
        self.slot.zero_()
        if self.graphs is not None:
            def call(key):
                self.graphs[key].replay()
        else:
            def call(key):
                self._body(key)()
        with torch.no_grad():
            for _ in range(n):
                self._one(call)

    def fetch(self, n: int) -> dict:
        """The last advance's n iterations as numpy (C, n, ...): {"pos":
        {name: ...}, "accept", "divergent", "eps", "dh", "steps"} and, NUTS,
        "depth" (its leaves needed go to counts()); one host fetch."""
        def host(v):
            # a copy: on the CPU .cpu() would hand out the buffer itself
            return v[:, :n].to("cpu", copy=True).numpy()
        out = {"pos": {k: host(v) for k, v in self.out["pos"].items()},
               **{k: host(v) for k, v in self.out.items() if k != "pos"}}
        if self.nuts:
            _COUNTS["leaves_needed"] += int(out.pop("leaves_needed").sum())
        return out

    def run(self, n: int) -> dict:
        """advance(n), then fetch(n)."""
        self.advance(n)
        return self.fetch(n)


def _pick(flag: torch.Tensor, new: torch.Tensor, old: torch.Tensor
          ) -> torch.Tensor:
    """new where the per-chain flag (C,) holds, else old (C, ...)."""
    return torch.where(_bc(flag, new), new, old)


def nuts_leaf_masks(max_d: int) -> tuple:
    """The checkpoint slots of NUTS's leaves 0 .. 2^max_d - 1 of a subtree,
    as (2^max_d, max_d) bool tables: push[i, s], even leaf i pushes its
    (momentum, inclusive momentum sum) at slot s = popcount(i); check[i, s],
    odd leaf i, with t trailing one bits, closes the t balanced subtrees
    that end at it, whose left edges sit at slots popcount(i) - t ..
    popcount(i) - 1 (JAX's build_subtree; its out-of-bounds push of an odd
    leaf, which JAX drops, is no push here)."""
    n = 1 << max_d
    push = np.zeros((n, max_d), bool)
    check = np.zeros((n, max_d), bool)
    for i in range(n):
        pc = bin(i).count("1")
        if i % 2 == 0:
            push[i, pc] = True
        else:
            t = ((i + 1) & -(i + 1)).bit_length() - 1
            check[i, pc - t:pc] = True
    return push, check


def _warmup_schedule(cfg: HMCConfig) -> tuple:
    """(adapt, collect, switch) flags per iteration: a step-size-only
    phase, then expanding memoryless variance windows (Stan's)."""
    do_mass = cfg.adapt_mass and cfg.num_warmup >= 20
    w = cfg.num_warmup
    bounds = [int(0.15 * w), int(0.25 * w), int(0.45 * w), int(0.85 * w)]
    total = cfg.num_warmup + cfg.num_samples
    collect_f = np.zeros(total, np.float32)
    switch_f = np.zeros(total, np.float32)
    if do_mass:
        collect_f[bounds[0]:bounds[3]] = 1.0
        for b in bounds[1:]:
            switch_f[b - 1] = 1.0   # the metric update fires AFTER that draw
    adapt_f = (np.arange(total) < cfg.num_warmup).astype(np.float32)
    return adapt_f, collect_f, switch_f


def _resolve_packed(cfg: HMCConfig, dev: torch.device,
                   deep_params=None) -> bool:
    """use_packed_kernel=None: the one-pass kernels on the card for the
    binary links; dense PyTorch for grm/gpcm/deep and on the CPU. An
    explicit True on the deep link raises at a width the fused op does not
    support (pallas_deep.supports) rather than run the dense potential."""
    use_pk = cfg.use_packed_kernel
    if use_pk is None:
        use_pk = (dev.type == "cuda"
                  and cfg.irt_model in ("1pl", "2pl", "3pl"))
    if (use_pk and cfg.irt_model == "deep"
            and not pallas_deep.supports(deep_params)):
        raise ValueError(
            f"use_packed_kernel=True: the fused deep potential needs a link "
            f"width H that is a multiple of 128, got H = "
            f"{int(deep_params['w_theta'].shape[1])}")
    return bool(use_pk)


def fisher_scale(mask_np: np.ndarray, spec: dict, dev) -> dict:
    """The whitening's scale: q = center + scale * x, scale the Fisher
    posterior sd of each coordinate (var ~ 1/(1 + count/4): a response
    carries Bernoulli information <= 1/4, plus the unit prior). In f32 it
    is what keeps the leapfrog's increments above a position's rounding at
    large N x M."""
    theta_sd = 1.0 / np.sqrt(1.0 + 0.25 * mask_np.sum(1))
    item_sd = 1.0 / np.sqrt(1.0 + 0.25 * mask_np.sum(0))
    scale = {}
    for name, shape in spec.items():
        sd = theta_sd if name == "theta" else item_sd
        if len(shape) == 2:
            sd = np.broadcast_to(sd[:, None], shape)
        scale[name] = torch.from_numpy(np.array(sd, np.float32)).to(dev)
    return scale


def run_hmc(resp, mask, cfg: HMCConfig, deep_params=None, device=None):
    """Run cfg.num_chains HMC chains (batched: one launch a chain of each
    kernel) on the response matrix (numpy (N, M) response and mask).

    deep_params: required when cfg.irt_model == "deep", the TRAINED decoder
    (a VIBO params["deep_link"] tree, numpy or torch), fixed while (theta,
    d) are sampled. device: None = the card (there is no fallback).

    Returns {"samples": {name: (C*S, ...)} pooled draws (numpy),
    "accept_rate", "step_size", "diagnostics"}, the JAX package's keys.
    The chains run in chunks of scan_chunk iterations (a `Sampler`: CUDA
    graph replays on the card) with one host fetch a chunk; the draws come
    from a torch.Generator seeded with cfg.seed."""
    dev = resolve_device(device)
    return _run_hmc_impl(resp, mask, cfg, deep_params, dev)


def _run_hmc_impl(resp, mask, cfg: HMCConfig, deep_params, dev):
    resp_np = np.asarray(resp, np.float32)
    mask_np = np.asarray(mask, np.float32)
    n, m = resp_np.shape
    if cfg.init_mode not in ("map", "prior"):
        raise ValueError(f"init_mode must be 'map' or 'prior', got "
                         f"{cfg.init_mode!r}")
    if cfg.trajectory not in ("fixed", "nuts"):
        raise ValueError(f"trajectory must be 'fixed' or 'nuts', got "
                         f"{cfg.trajectory!r}")
    if cfg.irt_model == "deep":
        if deep_params is None:
            raise ValueError(
                "irt_model='deep' samples under a TRAINED decoder: pass "
                "deep_params (a VIBO params['deep_link'] tree)")
        deep_params = _deep_on(deep_params, dev)
        cfg = dataclasses.replace(
            cfg,
            deep_latent_dim=int(deep_params["w_item"].shape[0]),
            deep_hidden_dim=int(deep_params["w_theta"].shape[1]))
    use_pk = _resolve_packed(cfg, dev, deep_params)
    if use_pk:
        # the code is the only response-sized upload
        base_data = {"pk": torch.from_numpy(
            pack_responses(resp_np, mask_np)).to(dev)}
    else:
        base_data = {"resp": torch.from_numpy(resp_np).to(dev),
                     "mask": torch.from_numpy(mask_np).to(dev)}
    if cfg.irt_model == "deep":
        base_data["deep"] = deep_params
    cfg = dataclasses.replace(cfg, use_packed_kernel=use_pk)
    programs = _chain_programs(cfg, n, m)
    spec, names = programs.spec, programs.names
    n_chains = max(1, cfg.num_chains)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    scale = fisher_scale(mask_np, spec, dev)
    if cfg.init_mode == "map":
        # every chain near the joint MAP (Adam on the same potential),
        # over-dispersed by init_overdispersion posterior sds; the start is
        # small-random, not zeros (theta = a = 0 is a saddle)
        params0 = {k: 0.1 * normal(spec[k]) for k in names}
        center = programs.map_run(params0, base_data)
        positions = {k: cfg.init_overdispersion
                     * normal((n_chains,) + spec[k]) for k in names}
    else:
        center = {k: torch.zeros(spec[k], device=dev) for k in names}
        positions = {k: 0.5 * normal((n_chains,) + spec[k]) / scale[k]
                     for k in names}

    # the per-person reference loglik at the center (make_potential's
    # ll_ref): f32 energy resolution at large N x M
    ll_ref = programs.ll_ref_fn(center, base_data)
    data = dict(base_data, center=center, scale=scale, ll_ref=ll_ref)

    total = cfg.num_warmup + cfg.num_samples
    state = programs.init(positions, data)
    chunk = max(1, int(cfg.scan_chunk))
    if cfg.trajectory == "fixed" and cfg.num_leapfrog > 64:
        # keep leapfrogs per chunk at the 64 * scan_chunk budget
        chunk = max(1, (chunk * 64) // int(cfg.num_leapfrog))
    sampler = Sampler(programs, state, data, gen,
                      np.stack(_warmup_schedule(cfg)), min(chunk, total))
    outs = [sampler.run(min(chunk, total - i)) for i in range(0, total, chunk)]
    state = sampler.state
    out = {k: np.concatenate([o[k] for o in outs], axis=1)
           for k in OUT_KEYS[1:]}
    out["pos"] = {k: np.concatenate([o["pos"][k] for o in outs], axis=1)
                  for k in names}
    sample_slice = slice(cfg.num_warmup, total, cfg.thin)
    # (C, S', ...) per-chain stacks feed the diagnostics; the pooled
    # (C*S', ...) stacks are the posterior. Draws leave x-space here.
    center_np = {k: v.cpu().numpy() for k, v in center.items()}
    scale_np = {k: v.cpu().numpy() for k, v in scale.items()}
    chain_samples = {k: center_np[k] + scale_np[k] * v[:, sample_slice]
                     for k, v in out["pos"].items()}
    chain_samples = _align_chain_signs(chain_samples)
    samples = {k: v.reshape((-1,) + v.shape[2:])
               for k, v in chain_samples.items()}
    accept_rate = float(out["accept"][:, cfg.num_warmup:].mean())
    step_sizes = torch.exp(state["log_eps_bar"]).cpu().numpy()
    divergences = int(out["divergent"][:, cfg.num_warmup:].sum())

    rhat_by, ess_by = {}, {}
    for name, v in chain_samples.items():
        if n_chains >= 2 and v.shape[1] >= 4:
            rhat_by[name] = float(np.nanmax(split_rhat(v)))
        ess_by[name] = float(np.nanmin(effective_sample_size(v)))
    # the self-reported noise ceiling of cross-method sd agreement: the
    # Pearson of per-person theta sds between the two halves of the chains
    sd_ceiling = float("nan")
    th = chain_samples.get("theta")
    if th is not None and n_chains >= 2:
        half = n_chains // 2
        sd_a = th[:half].reshape((-1,) + th.shape[2:]).std(0).ravel()
        sd_b = th[half:2 * half].reshape((-1,) + th.shape[2:]).std(0).ravel()
        if sd_a.std() > 0 and sd_b.std() > 0:
            sd_ceiling = float(np.corrcoef(sd_a, sd_b)[0, 1])
    diagnostics = {
        "theta_sd_split_half_r": sd_ceiling,
        "num_chains": n_chains,
        "rhat": rhat_by,
        "rhat_max": max(rhat_by.values()) if rhat_by else float("nan"),
        "ess": ess_by,
        "ess_min": min(ess_by.values()) if ess_by else float("nan"),
        "divergences": divergences,
        "step_sizes": step_sizes.tolist(),
        # with init_mode="map" R-hat certifies mixing around the MAP's
        # basin on gauge-fixed draws, not the absence of a distant mode
        "init_mode": cfg.init_mode,
        "trajectory": cfg.trajectory,
        # leapfrog evaluations a draw, measured over the draws (constant
        # for fixed trajectories, NUTS's dynamic lengths)
        "leapfrogs_per_draw": (float(out["steps"][:, cfg.num_warmup:].mean())
                               if cfg.num_samples else float("nan")),
        # per-iteration adaptation traces (chain-major), raw arrays
        "_eps_trace": out["eps"],
        "_dh_trace": out["dh"],
    }
    return {"samples": samples, "accept_rate": accept_rate,
            "step_size": float(step_sizes.mean()),
            "diagnostics": diagnostics}


def _adam_map(u_fn, params: dict, steps: int) -> dict:
    """Adam (0.05, optax.adam's form) for steps steps on the scalar
    potential u_fn from params -> the end point, detached."""
    from vibo_tpu_torch.train.trainer import make_optimizer
    leaves = {k: params[k].detach().clone().requires_grad_()
              for k in sorted(params)}
    opt = make_optimizer(leaves, 0.05)
    order = list(leaves.values())
    for _ in range(steps):
        with torch.enable_grad():
            grads = torch.autograd.grad(u_fn(leaves), order)
        for p, g in zip(order, grads):
            p.grad = g
        opt.step()
    return {k: v.detach() for k, v in leaves.items()}


def _find_mode(u_fn, spec, cfg: HMCConfig, generator: torch.Generator):
    """Joint MAP by _adam_map on the potential u_fn for map_init_steps
    steps, from a small random start drawn from the generator (theta = a =
    0 is a saddle where both gradients vanish)."""
    dev = generator.device
    params = {k: 0.1 * torch.randn(spec[k], generator=generator, device=dev)
              for k in sorted(spec)}
    return _adam_map(u_fn, params, cfg.map_init_steps)


def _align_chain_signs(chain_samples: dict) -> dict:
    """Resolve the O(K) rotation/reflection non-identifiability of the
    links with discriminations: align every draw by the orthogonal
    Procrustes rotation of its a block onto a self-consistent reference
    (chain 0's mean a, re-estimated from all aligned draws a few times),
    rotating theta by the same R. Each aligned draw is still an exact
    posterior draw. No 'a' (1PL, deep): unchanged."""
    if "a" not in chain_samples:
        return chain_samples
    a = chain_samples["a"]            # (C, S, M, K)
    theta = chain_samples["theta"]    # (C, S, N, K)
    c, s, m, k = a.shape
    flat_a = a.reshape(c * s, m, k)
    ref = a[0].mean(0)                # (M, K)
    for _ in range(3):
        # Procrustes per draw: M_i = a_i^T ref = U S V^T  ->  R_i = U V^T
        cross = np.einsum("bmk,ml->bkl", flat_a, ref)
        u, _, vt = np.linalg.svd(cross)
        rot = np.einsum("bkl,blj->bkj", u, vt)      # (B, K, K)
        aligned_a = np.einsum("bmk,bkj->bmj", flat_a, rot)
        new_ref = aligned_a.mean(0)
        if np.allclose(new_ref, ref, atol=1e-6):
            break
        ref = new_ref
    out = dict(chain_samples)
    out["a"] = aligned_a.reshape(c, s, m, k)
    n = theta.shape[2]
    out["theta"] = np.einsum(
        "bnk,bkj->bnj", theta.reshape(c * s, n, k), rot).reshape(c, s, n, k)
    return out


def split_rhat(x: np.ndarray) -> np.ndarray:
    """Split-R-hat (Gelman et al., BDA3 11.4) per scalar parameter:
    x (C, S, ...) per-chain stacks -> (...); > 1.05 is the conventional
    failure threshold."""
    x = np.asarray(x, np.float64)
    c, s = x.shape[:2]
    s2 = s // 2
    x = x[:, :2 * s2].reshape((2 * c, s2) + x.shape[2:])
    mean_c = x.mean(1)
    var_c = x.var(1, ddof=1)
    w = var_c.mean(0)
    b = s2 * mean_c.var(0, ddof=1)
    var_plus = (s2 - 1) / s2 * w + b / s2
    return np.sqrt(var_plus / np.maximum(w, 1e-300))


def effective_sample_size(x: np.ndarray) -> np.ndarray:
    """Within-chain bulk ESS per scalar parameter (Geyer initial monotone
    positive sequence on the chain-averaged autocorrelation): x (C, S, ...)
    -> (...) effective draws out of C*S. The per-chain FFT runs in f32,
    everything after the chain average in f64."""
    x = np.asarray(x, np.float32)
    c, s = x.shape[:2]
    xc = x - x.mean(1, keepdims=True)
    n_fft = 1 << (2 * s - 1).bit_length()
    f = np.fft.rfft(xc, n=n_fft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), axis=1)[:, :s] / s   # (C, S, ...)
    acov = acov.mean(0, dtype=np.float64)                    # (S, ...)
    var0 = np.maximum(acov[0], 1e-300)
    rho = acov / var0
    # Geyer pairwise sums rho_{2t} + rho_{2t+1}; truncate at the first
    # negative pair, enforce a monotone non-increasing envelope
    t_max = (s - 1) // 2
    pair = rho[1:2 * t_max + 1:2] + rho[2:2 * t_max + 2:2]   # (t_max, ...)
    pair = np.minimum.accumulate(np.maximum(pair, 0.0), axis=0)
    alive = np.cumprod(pair > 0, axis=0)
    tau = 1.0 + 2.0 * (pair * alive).sum(0)
    return c * s / np.maximum(tau, 1e-300)


def posterior_mean_prob(samples: dict, irt_model: str,
                        sample_chunk: int = 8,
                        deep_params: dict | None = None,
                        device=None) -> np.ndarray:
    """Posterior-predictive response probabilities E_s[link(theta_s, d_s)]
    over the draws (numpy (S, ...) stacks) -> numpy f32 (N, M), or (N, M,
    C) category probabilities for grm/gpcm. The draws stream through in
    chunks of sample_chunk (the (S, N, M) tensor never exists); each
    chunk's f32 sum is added in f64. device: None = the card."""
    dev = resolve_device(device)
    n_samples = samples["theta"].shape[0]
    if irt_model == "deep":
        dp = _deep_on(deep_params, dev)

        def chunk_prob(t, d):
            return torch.sigmoid(networks.apply_deep_link(dp, t, d,
                                                          item_chunk=256))
        args = ("theta", "d")
    elif irt_model == "1pl":
        def chunk_prob(t, b):
            return torch.sigmoid(links.logits_1pl(t, b))
        args = ("theta", "b")
    elif irt_model == "2pl":
        def chunk_prob(t, a, b):
            return torch.sigmoid(links.logits_2pl(t, a, b))
        args = ("theta", "a", "b")
    elif irt_model in ("grm", "gpcm"):
        def chunk_prob(t, a, b):
            return torch.exp(lik.categorical_logprob_all(
                irt_model, links.grm_base(t, a),
                links.categorical_table(irt_model, b)))
        args = ("theta", "a", "b")
    else:
        chunk_prob = links.prob_3pl
        args = ("theta", "a", "b", "g_hat")

    total = None
    with torch.no_grad():
        for s in range(0, n_samples, sample_chunk):
            chunk = [_f32(samples[k][s:s + sample_chunk], dev) for k in args]
            part = chunk_prob(*chunk).sum(0).double()
            total = part if total is None else total + part
    return (total / n_samples).float().cpu().numpy()
