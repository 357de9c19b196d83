"""Depth sweep of chip_smoke.py's HMC gold comparisons on one card.

    python3 hmc_depth.py [--smoke] [gold ... | deep-H256]

Runs the port's `run_hmc` on the data of artifacts/gold/k4 (2PL, 10,240 x
1,024, K = 4, the (B, K) one-pass kernel) and of artifacts/gold/grm (2,000 x
100, C = 5, the dense potential) at each (warm-up, draws, leapfrogs) of
DEPTHS, and on the data of the NUTS golds k2-nuts (2PL, 2,000 x 200, K = 2,
the one-pass kernel), grm-k2 and grm-k4 (2,000 x 200, K = 2 and 4, C = 5,
dense) at each (warm-up, draws), NUTS at the golds' tree depth 7 and target
0.8; with chip_smoke.py's chains and seed (the fixed runs at its accept
target). Prints one JSON line a run: its seconds, accept rate, R-hat,
leapfrogs a draw, and the agreement with the gold and whether its gates
hold (`chip_smoke.gold_agreement`). Then the card's name and power limit,
and last {"ok": true} when every run held its gates. Arguments: only those
golds; --smoke: each gold at chip_smoke.py's HMC_GOLD_DEPTH only.
chip_smoke.py's HMC_GOLD_DEPTH is taken from such a sweep. run_hmc replays
its iterations from CUDA graphs (`hmc.Sampler`), so the sweep reaches the
k4 gold's own 800 + 1,600 iterations (~1 min of the card).

`deep-H256` (named like a gold; not run by default): chip_smoke.py's
hmc_deep_f32_H256 path, a decoder of link width 256 trained as its, at each
(warm-up, draws, leapfrogs) of DEEP_DEPTHS through both potentials (dense,
row 15f's cluster kernel); then the kernel route's run at HMC_SHORT replayed
eagerly (`step_with_noise` on the same generator, which chip_smoke.py's
hmc_graph gate holds bitwise against the sampler's graphs). Its warm-up
trajectory of largest |dH| is re-run from the same state and noise through
the dense potential, and at each of its leapfrog positions U and its
gradient by both routes are held against the exact function the kernel
evaluates (chip_smoke.deep_potential_f64, in f64) and the op against its
plain version (`fused_deep_plain`); its draws are re-run from the
warm-up's end through the dense potential. Gated: the two routes' dH from
that state within 1e-5 of each other, and at every position the kernel
route's U within 1e-5 of the exact one and its gradient within 1e-4 of
the exact one's largest magnitude, chain by chain.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

DEPTHS = {"k4": [(50, 50, 64), (100, 100, 64), (200, 200, 64),
                 (400, 400, 64), (800, 1600, 64)],
          "grm": [(30, 30, 32), (50, 50, 32), (100, 100, 32),
                  (200, 200, 32)],
          **{gold: [(30, 30), (50, 50), (100, 100), (200, 200)]
             for gold in cs.NUTS_GOLDS}}
DEEP_WIDE = "deep-H256"
DEEP_DEPTHS = [cs.HMC_SHORT, (30, 20, 16), cs.DEEP_HMC_WIDE_DEPTH]


def per_chain_rel(got, ref) -> float:
    """max over chains of max|got - ref| / max|ref| (leading chain axis)."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs().flatten(1).amax(1)
    return float((err / ref.abs().flatten(1).amax(1).clamp_min(1e-30)).max())


def deep_witness(ds, decoder, depth) -> dict:
    """The kernel route's run at depth replayed eagerly (run_hmc's start:
    the MAP on the kernel potential, its positions, ll_ref; then
    step_with_noise a step on the same generator), with the trajectory of
    largest |dH| in warm-up re-run through the dense potential and checked
    point by point against the exact function (in f64), and the draws
    re-run through the dense potential from the warm-up's end."""
    import dataclasses
    from vibo_tpu_torch.models import hmc
    from vibo_tpu_torch.ops import pallas_deep as pd
    from vibo_tpu_torch.ops.packing import pack_responses
    resp = np.asarray(ds.response, np.float32)
    mask = np.asarray(ds.train_mask, np.float32)
    n, m = resp.shape
    link = hmc._deep_on(decoder, "cuda")
    cfg = dataclasses.replace(
        cs.hmc_cfg("deep", cs.DEEP_K, depth=depth),
        deep_latent_dim=int(link["w_item"].shape[0]),
        deep_hidden_dim=int(link["w_theta"].shape[1]))
    kern, dense = (hmc._chain_programs(dataclasses.replace(
        cfg, use_packed_kernel=pk), n, m) for pk in (True, False))
    chains, names = cfg.num_chains, kern.names
    pk = torch.from_numpy(pack_responses(resp, mask)).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cfg.seed)
    base = {"pk": pk, "deep": link}
    scale = hmc.fisher_scale(mask, kern.spec, "cuda")
    center = kern.map_run({k: 0.1 * torch.randn(
        kern.spec[k], generator=gen, device="cuda") for k in names}, base)
    pos = {k: cfg.init_overdispersion * torch.randn(
        (chains,) + kern.spec[k], generator=gen, device="cuda")
        for k in names}
    common = {"center": center, "scale": scale,
              "ll_ref": kern.ll_ref_fn(center, base)}
    data_k = dict(base, **common)
    data_d = dict(resp=torch.from_numpy(resp).cuda(),
                  mask=torch.from_numpy(mask).cuda(), deep=link, **common)
    flags = np.stack(hmc._warmup_schedule(cfg))
    warm, total = cfg.num_warmup, flags.shape[1]
    state = kern.init(pos, data_k)
    states, noises, outs = [], [], []
    for i in range(total):
        noises.append(kern.draw_noise(gen, chains))
        states.append(state)
        state, out = kern.step_with_noise(state, noises[-1], *flags[:, i],
                                          data_k)
        outs.append(out)
    dh = torch.stack([o["dh"] for o in outs])                   # (T, C)
    size = torch.where(torch.isfinite(dh), dh.abs(), torch.inf)
    worst = int(size[:warm].amax(1).argmax())
    before, noise = states[worst], noises[worst]
    adapt = torch.as_tensor(flags[0, worst], dtype=torch.float32,
                            device="cuda")
    mom = kern.momentum(before, noise)
    eps = kern.step_size(before, adapt)
    again = kern.fixed_draw(before, mom, eps, noise, data_k)
    u_d, g_d = dense.vg(before["pos"], data_d)
    moved_d = dense.fixed_draw(dict(before, u=u_d, g=g_d), mom, eps, noise,
                               data_d)
    # the leapfrog of hmc._chain_programs, its positions kept
    e = eps * (1.0 - noise["jitter"] / 3.0)
    inv = before["inv_mass"]
    x = dict(before["pos"])
    p = {k: mom[k] - 0.5 * hmc._bc(e, x[k]) * before["g"][k] for k in names}
    points = []
    for step in range(cfg.num_leapfrog):
        x = {k: x[k] + hmc._bc(e, x[k]) * inv[k] * p[k] for k in names}
        (u1, g1), (u0, g0) = kern.vg(x, data_k), dense.vg(x, data_d)
        u64, g64 = cs.deep_potential_f64(x, data_d, link)
        points.append({
            "x_max": max(float(x[k].abs().max()) for k in names),
            "u_f64": u64.tolist(),
            "kernel_u_rel": float(((u1.double() - u64).abs()
                                   / u64.abs()).max()),
            "dense_u_rel": float(((u0.double() - u64).abs()
                                  / u64.abs()).max()),
            "kernel_grad_rel": max(per_chain_rel(g1[k], g64[k])
                                   for k in names),
            "dense_grad_rel": max(per_chain_rel(g0[k], g64[k])
                                  for k in names)})
        p = {k: p[k] - hmc._bc(e, x[k]) * g1[k] for k in names}
    q = {k: center[k] + scale[k] * x[k] for k in names}
    op = {}
    for c in range(chains):
        args = cs.deep_args(link, q["theta"][c], q["d"][c], pk)
        got = pd.train_cuda(*args, f32_dots=True)
        ref = pd.fused_deep_plain(*args, f32_dots=True)
        for name, a, b in zip(("ll", "s_theta", "s_d", "dW2", "db2", "dwo",
                               "dbo"), got, ref):
            op[name] = max(op.get(name, 0.0), cs.rel_err(a, b))
    # the draws from the kernel route's warm-up end, through the dense
    # potential on the same noise
    st = states[warm]
    u_d, g_d = dense.vg(st["pos"], data_d)
    st = dict(st, u=u_d, g=g_d)
    dense_accept = []
    for i in range(warm, total):
        st, o = dense.step_with_noise(st, noises[i], *flags[:, i], data_d)
        dense_accept.append(o["accept"])
    accept = torch.stack([o["accept"] for o in outs])
    return {
        "depth": list(depth), "worst_iteration": worst,
        "flags": flags[:, worst].tolist(),
        "max_abs_dh_by_iteration": size[:warm].amax(1).tolist(),
        "step_by_iteration": [float(o["eps"].mean()) for o in outs[:warm]],
        "dh_kernel": again["dh"].tolist(), "dh_recorded": dh[worst].tolist(),
        "dh_dense_same_start": moved_d["dh"].tolist(),
        "accept_kernel_same_start": again["accept"].tolist(),
        "accept_dense_same_start": moved_d["accept"].tolist(),
        "trajectory": points, "op_rel_err_at_end_vs_plain": op,
        "draws_accept_kernel": float(accept[warm:].mean()),
        "draws_accept_dense_same_start": float(
            torch.stack(dense_accept).mean()),
        "witness_holds": all(pt["kernel_u_rel"] <= 1e-5
                             and pt["kernel_grad_rel"] <= 1e-4
                             for pt in points)
        and bool((((again["dh"] - moved_d["dh"]).abs()
                   / moved_d["dh"].abs()) <= 1e-5).all())}


def deep_runs(smi: str) -> bool:
    """DEEP_WIDE: both routes at each of DEEP_DEPTHS, then the witness at
    HMC_SHORT; one JSON line each -> whether the witness held."""
    from vibo_tpu_torch.models import hmc
    ds, decoder = cs.deep_decoder(smi, cs.DEEP_HMC_WIDE_H)
    rates = {}
    for depth in DEEP_DEPTHS:
        for packed in (False, True):
            cfg = cs.hmc_cfg("deep", cs.DEEP_K, depth=depth,
                             use_packed_kernel=packed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = hmc.run_hmc(ds.response, ds.train_mask, cfg,
                              deep_params=decoder)
            torch.cuda.synchronize()
            route = "kernel" if packed else "dense"
            rates[(tuple(depth), route)] = out["accept_rate"]
            print(json.dumps({
                "gold": DEEP_WIDE, "route": route, "depth": list(depth),
                "seconds": time.perf_counter() - t0,
                "accept_rate": out["accept_rate"],
                "step_size": out["step_size"],
                "rhat_max": out["diagnostics"]["rhat_max"],
                "divergences": out["diagnostics"]["divergences"]}),
                flush=True)
    t0 = time.perf_counter()
    r = deep_witness(ds, decoder, cs.HMC_SHORT)
    r.update(gold=DEEP_WIDE, seconds=time.perf_counter() - t0,
             run_hmc_accept_rate=rates[(tuple(cs.HMC_SHORT), "kernel")])
    print(json.dumps(r), flush=True)
    return r["witness_holds"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("hmc_depth.py needs a CUDA card")
    from vibo_tpu_torch._device import resolve_device
    from vibo_tpu_torch.models import hmc
    resolve_device(None)
    smi = cs.nvidia_smi("name,power.limit")
    args = sys.argv[1:]
    smoke = "--smoke" in args
    golds = [a for a in args if a != "--smoke"]
    ok = True
    if DEEP_WIDE in golds:
        golds.remove(DEEP_WIDE)
        ok = deep_runs(smi)
        sweep = {gold: DEPTHS[gold] for gold in golds}
    else:
        sweep = {gold: depths for gold, depths in DEPTHS.items()
                 if not golds or gold in golds}
    for gold, depths in sweep.items():
        if smoke:
            depths = [cs.HMC_GOLD_DEPTH[gold]]
        ds = cs.gold_data(gold)
        model, k = {"k4": ("2pl", cs.K), "grm": ("grm", 1),
                    **cs.NUTS_GOLDS}[gold]
        c = cs.C if model == "grm" else 2
        for depth in depths:
            cfg = cs.hmc_cfg(model, k, c, depth=depth)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = hmc.run_hmc(ds.response, ds.train_mask, cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            prob = hmc.posterior_mean_prob(out["samples"], model)
            r = {"gold": gold, "depth": list(depth), "seconds": seconds,
                 "accept_rate": out["accept_rate"],
                 "step_size": out["step_size"],
                 "rhat_max": out["diagnostics"]["rhat_max"],
                 "leapfrogs_per_draw": out["diagnostics"][
                     "leapfrogs_per_draw"],
                 "divergences": out["diagnostics"]["divergences"],
                 **cs.gold_agreement(out["samples"],
                                     cs.heldout_accuracy(prob, ds), gold)}
            ok = ok and r["gold_gates_hold"]
            print(json.dumps(r), flush=True)
    print(smi)
    print(json.dumps({"ok": ok}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
