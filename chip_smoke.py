"""Smoke run of the PyTorch/CUDA port (`vibo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):
  1. device: a CUDA card is required (no CPU fallback);
  2. build: nvcc compiles every csrc/*.cu of the port, in parallel;
  3. kernel checks: each hand-written kernel against its plain PyTorch
     version on the card, with CUDA-event times of the kernel, the plain
     version and, where one PyTorch call computes the same function, that
     call (timed only, never used by the port): the full-batch kernels at
     the flagship shape (10,240 students x 1,024 items, K=4, hidden 256),
     the general masked loglik (both cell readers, a non-uniform cotangent,
     all-missing rows exactly inert) at the minibatch shape (4,096 x 1,024)
     as the ELBO steps call it, with the IWAE steps' 5 samples, and on the
     padded last batch, and all of them at a ragged shape, the masked
     loglik also with a leading sample axis, at K = 1 and 8, and with M off
     the vector width;
  4. small-shape checks of the packed and the decoded-data objectives and
     every gradient on the card against the CPU path;
  5. full-batch path: the 2PL flagship (bf16 encoder, conditional
     posterior, transposed theta) trains >= 30 steps through Trainer.step,
     launching the full-batch kernels and not the masked loglik; then
     held-out imputation accuracy and AbilityScorer.score on fresh
     students, and a torch.profiler window: device time by kernel;
  6. minibatch path: Trainer.fit with batch_size 4,096 (3 steps an epoch,
     the last padded with 2,048 all-zero rows) trains 4 epochs on decoded
     data with the ELBO, launching the masked loglik's dense reader and no
     full-batch kernel, then 3 IWAE steps (S = 5); the fit's host work
     (batch slicing, copy to the card) timed on its own, step times on
     device-resident batches and a profiler window;
  7. held-out IWAE-100 log-likelihood of the trained params (iwae_loglik).
Then the kernels summary line, the card's name and power limit, and the
final status line {"ok": true, "device": {...}}.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s f32 outside them.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

B, M, K, H = 10240, 1024, 4, 256          # flagship shape (bench.py)
BATCH = 4096                              # minibatch (cli.py --batch-size)
RAGGED = (1000, 300)                      # students, items: edge masking
ODD = (777, 301)                          # M off the 4-item vector width
STEPS = 40                                # full-batch steps
EPOCHS = 4                                # minibatch epochs (3 steps each)
IWAE_STEPS, IWAE_S = 3, 5                 # IWAE training steps, samples
FULL_BATCH_KERNELS = ("first_layer_fwd", "first_layer_bwd",
                      "loglik_2pl_train")
MINIBATCH_KERNELS = ("masked_loglik_2pl_fwd", "masked_loglik_2pl_bwd")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| (0-d tensors included)."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def max_abs(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


class Timer:
    """Median CUDA-event time of fn, with the 50 MB L2 flushed before every
    launch: the step's other work (dense layers, optimizer) passes far more
    than L2 between two launches of any one kernel."""

    def __init__(self):
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = 15) -> float:
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def check_first_layer(timer, pk, rng_gen, timed: bool) -> dict:
    from vibo_tpu_torch.ops import pallas_encoder as enc
    from vibo_tpu_torch.ops.packing import decode_packed
    bsz, m = pk.shape
    wr = 0.05 * torch.randn((m, H), generator=rng_gen, device="cuda")
    wm = 0.05 * torch.randn((m, H), generator=rng_gen, device="cuda")
    dh = torch.randn((bsz, H), generator=rng_gen, device="cuda")
    h_k = enc.first_layer_fwd_cuda(pk, wr, wm)
    h_p = enc.first_layer_plain(pk, wr, wm, torch.bfloat16)
    dwr_k, dwm_k = enc.first_layer_bwd_cuda(pk, dh)
    dwr_p, dwm_p = enc.first_layer_bwd_plain(pk, dh, torch.bfloat16)
    torch.cuda.synchronize()
    fwd = {"rel_err": rel_err(h_k, h_p), "max_abs_err": max_abs(h_k, h_p)}
    bwd = {"rel_err": max(rel_err(dwr_k, dwr_p), rel_err(dwm_k, dwm_p)),
           "max_abs_err": max(max_abs(dwr_k, dwr_p), max_abs(dwm_k, dwm_p))}
    for name, r in (("first_layer_fwd", fwd), ("first_layer_bwd", bwd)):
        if not r["rel_err"] <= 1e-4:
            raise AssertionError(f"{name} at {tuple(pk.shape)} disagrees "
                                 f"with its plain version: {r}")
    if timed:
        m_, rm_ = (x.to(torch.bfloat16) for x in decode_packed(pk))
        x_cat = torch.cat([rm_, m_], dim=1)                 # (B, 2M)
        w_cat = torch.cat([wr, wm]).to(torch.bfloat16)      # (2M, H)
        dh16 = dh.to(torch.bfloat16)
        ops = 4 * bsz * m * H
        fwd.update(ms=timer(lambda: enc.first_layer_fwd_cuda(pk, wr, wm)),
                   plain_ms=timer(lambda: enc.first_layer_plain(
                       pk, wr, wm, torch.bfloat16)),
                   library_ms=timer(lambda: torch.matmul(x_cat, w_cat)))
        fwd["bound_ms"], fwd["bound_by"] = bound_ms(
            bsz * m + 2 * m * H * 4 + bsz * H * 4, ops, BF16_FLOPS)
        bwd.update(ms=timer(lambda: enc.first_layer_bwd_cuda(pk, dh)),
                   plain_ms=timer(lambda: enc.first_layer_bwd_plain(
                       pk, dh, torch.bfloat16)),
                   library_ms=timer(lambda: torch.matmul(x_cat.T, dh16)))
        bwd["bound_ms"], bwd["bound_by"] = bound_ms(
            bsz * m + bsz * H * 4 + 2 * m * H * 4, ops, BF16_FLOPS)
    return {"first_layer_fwd": fwd, "first_layer_bwd": bwd}


def check_loglik(timer, pk, rng_gen, timed: bool) -> dict:
    from vibo_tpu_torch.ops import pallas_elbo as el
    bsz, m = pk.shape
    theta_t = torch.randn((K, bsz), generator=rng_gen, device="cuda")
    a = 0.5 * torch.randn((m, K), generator=rng_gen, device="cuda")
    b = torch.randn((m,), generator=rng_gen, device="cuda")
    out = {}
    for layout in ("kb", "bk"):
        theta = theta_t.T if layout == "kb" else theta_t.T.contiguous()
        dth = torch.empty((K, bsz), device="cuda").T if layout == "kb" \
            else torch.empty((bsz, K), device="cuda")

        def launch():
            return el.loglik_2pl_train_cuda(theta, a, b, pk, dth,
                                            per_person=layout == "bk")
        ll_k, da_k, db_k = launch()
        ll_p, dth_p, da_p, db_p = el.loglik_2pl_train_plain(theta, a, b, pk)
        if layout == "kb":
            ll_p = ll_p.sum()
        torch.cuda.synchronize()
        r = {"ll_rel_err": rel_err(ll_k, ll_p),
             "grad_rel_err": max(rel_err(dth, dth_p), rel_err(da_k, da_p),
                                 rel_err(db_k, db_p)),
             "max_abs_err": max(max_abs(ll_k, ll_p), max_abs(dth, dth_p),
                                max_abs(da_k, da_p), max_abs(db_k, db_p))}
        if not (r["ll_rel_err"] <= 1e-5 and r["grad_rel_err"] <= 1e-4):
            raise AssertionError(f"loglik_2pl_train ({layout}) at "
                                 f"{tuple(pk.shape)} disagrees with its "
                                 f"plain version: {r}")
        if timed:
            r["ms"] = timer(launch)
            r["plain_ms"] = timer(
                lambda: el.loglik_2pl_train_plain(theta, a, b, pk))
            r["library_ms"] = None
            r["bound_ms"], r["bound_by"] = bound_ms(
                bsz * m + 2 * bsz * K * 4 + 2 * m * K * 4 + 2 * m * 4 + 4,
                (6 * K + 16) * bsz * m, F32_FLOPS)
        out[layout] = r
    return out


def masked_bound(bsz: int, m: int, k: int, cell_bytes: int, bwd: bool):
    """Bound of the masked loglik: each cell's data read once (8 bytes
    dense, 1 int8) plus theta, a, b (and g) read and ll (or dtheta, da, db)
    written once; 2K+9 f32 operations a cell forward, 6K+10 backward."""
    small = 4 * (bsz * k + m * k + m)
    if bwd:
        small += 4 * (bsz + bsz * k + m * k + m)
    else:
        small += 4 * bsz
    ops = ((6 * k + 10) if bwd else (2 * k + 9)) * bsz * m
    return bound_ms(cell_bytes * bsz * m + small, ops, F32_FLOPS)


def check_masked(timer, resp, mask, rng_gen, timed: bool,
                 samples: int | None = None, shared_items: bool = False,
                 k: int = K):
    """The general masked loglik's forward and backward kernels against
    their plain versions, dense and int8 readers, on (resp, mask) and a
    non-uniform cotangent, and all-missing rows exactly inert; samples: a
    leading sample axis of that length (per-sample a and b, or shared over
    the samples; the data is shared, as on the IWAE path); k: ability
    dims."""
    from vibo_tpu_torch.ops import pallas_elbo as el
    from vibo_tpu_torch.ops.packing import decode_packed, pack_responses
    bsz, m = resp.shape
    s = samples or 1
    sa = 1 if shared_items else s
    theta = torch.randn((s, bsz, k), generator=rng_gen, device="cuda")
    a = 0.5 * torch.randn((sa, m, k), generator=rng_gen, device="cuda")
    b = torch.randn((sa, m), generator=rng_gen, device="cuda")
    g = 2.0 * torch.rand((s, bsz), generator=rng_gen, device="cuda") - 0.5
    pk = pack_responses(resp, mask)
    out = {}
    for reader in ("dense", "int8"):
        data = ((resp[None], mask[None], None) if reader == "dense"
                else (None, None, pk[None]))

        def cells():
            if reader == "dense":
                return resp[None], mask[None]
            m_, r_ = decode_packed(pk[None])
            return r_, m_

        def fwd():
            return el.masked_loglik_2pl_fwd_cuda(theta, a, b, *data)

        def bwd():
            return el.masked_loglik_2pl_bwd_cuda(g, theta, a, b, *data)

        def fwd_plain():
            return el.masked_loglik_2pl_plain(theta, a, b, *cells())

        def bwd_plain():
            return el.masked_loglik_2pl_vjp_plain(g, theta, a, b, *cells())
        ll_k, grads_k = fwd(), bwd()
        ll_p, grads_p = fwd_plain(), bwd_plain()
        torch.cuda.synchronize()
        f = {"rel_err": rel_err(ll_k, ll_p), "max_abs_err": max_abs(ll_k,
                                                                    ll_p)}
        w = {"rel_err": max(rel_err(x, y) for x, y in zip(grads_k, grads_p)),
             "max_abs_err": max(max_abs(x, y)
                                for x, y in zip(grads_k, grads_p))}
        if not (f["rel_err"] <= 1e-5 and w["rel_err"] <= 1e-4):
            raise AssertionError(
                f"masked_loglik_2pl ({reader}, S={s}, shared_items="
                f"{shared_items}) at {(bsz, m)} disagrees with its plain "
                f"version: fwd {f}, bwd {w}")
        # rows with no observed cell (a last minibatch's zero padding) give
        # exactly 0 loglik and 0 dtheta
        empty = mask.sum(-1) == 0
        if not (ll_k[:, empty].eq(0).all()
                and grads_k[0][:, empty].eq(0).all()):
            raise AssertionError(f"masked_loglik_2pl ({reader}) at "
                                 f"{(bsz, m)}: an all-missing row is not "
                                 f"inert")
        f["inert_rows"] = int(empty.sum())
        if timed:
            nbytes = 8 if reader == "dense" else 1
            for r, kernel, plain, is_bwd in ((f, fwd, fwd_plain, False),
                                             (w, bwd, bwd_plain, True)):
                r.update(ms=timer(kernel), plain_ms=timer(plain),
                         library_ms=None)
                r["bound_ms"], r["bound_by"] = masked_bound(bsz, m, k,
                                                            nbytes, is_bwd)
        out[reader] = {"fwd": f, "bwd": w}
    return out


def objective_matches_cpu(decoded: bool) -> float:
    """An objective and every gradient at a small shape on the card
    (kernels) against the CPU (plain versions), same params and noise: the
    packed full-batch ELBO (S = 1, transposed theta), or the decoded-data
    minibatch ELBO (S = 2, item_scale 0.4, an all-missing row). bf16
    encoder, so 1e-2 of each array's largest magnitude (a bf16 rounding of
    an encoder operand may flip between the two)."""
    from vibo_tpu_torch.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves)
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    from vibo_tpu_torch.ops import objectives
    from vibo_tpu_torch.ops.packing import packed_on_device
    n, m = 300, 200
    s = 2 if decoded else 1
    rng = np.random.default_rng(3)
    resp = (rng.random((n, m)) < 0.5).astype(np.float32)
    mask = (rng.random((n, m)) < 0.9).astype(np.float32)
    mask[7] = 0.0
    cfg = VIBOConfig(num_items=m, irt_model="2pl", ability_dim=K,
                     hidden_dim=64, use_pallas=True, compute_dtype="bfloat16")
    params_np = params_to_numpy(VIBO(cfg, device="cpu").init_params(7))
    item_eps = {"a": rng.standard_normal((s, m, K)).astype(np.float32),
                "b": rng.standard_normal((s, m, 1)).astype(np.float32)}
    theta_eps = rng.standard_normal(
        (s, n, K) if decoded else (s, K, n)).astype(np.float32)
    results = []
    for dev in ("cuda", "cpu"):
        model = VIBO(cfg, device=dev)
        params = params_from_jax(params_np, dev)
        ie = {k: torch.from_numpy(v).to(dev) for k, v in item_eps.items()}
        te = torch.from_numpy(theta_eps).to(dev)
        if decoded:
            bound, aux = model.elbo_eps(
                params, torch.from_numpy(resp).to(dev),
                torch.from_numpy(mask).to(dev), ie, te, 0.4)
            terms = [aux[k] for k in ("loglik", "kl_theta", "kl_items")]
        else:
            packed, rv = packed_on_device(resp, mask, dev)
            terms = model.elbo_packed_sums(params, packed, ie, te, rv,
                                           transposed=True)
            bound = objectives.elbo(*terms)
        bound.backward()
        results.append([t.detach().cpu() for t in terms]
                       + [p.grad.cpu() for p in tree_leaves(params)])
    worst = max(rel_err(g, c) for g, c in zip(*results))
    if not worst <= 1e-2:
        raise AssertionError(f"{'decoded' if decoded else 'packed'} "
                             f"objective on the card disagrees with the CPU "
                             f"path: {worst}")
    return worst


def launch_counts() -> dict:
    from vibo_tpu_torch.ops import _build
    return {name: k.launches for name, k in _build.KERNELS.items()}


def reader_counts() -> dict:
    """Launches of the masked loglik's kernels by cell reader."""
    from vibo_tpu_torch.ops import _build
    return {n: dict(_build.KERNELS[n].launches_by) for n in MINIBATCH_KERNELS}


def check_dense_only(phase: str, readers: dict) -> None:
    if any(set(r) != {"dense"} for r in readers.values()):
        raise AssertionError(f"{phase} used another reader than the dense "
                             f"one: {readers}")


def check_path(phase: str, launches: dict, ran: tuple, idle: tuple) -> None:
    """The phase launched every kernel of its path and none of the other's."""
    missing = [n for n in ran if launches[n] == 0]
    stray = [n for n in idle if launches[n] != 0]
    if missing or stray:
        raise AssertionError(f"{phase}: kernels of the path not launched "
                             f"{missing}, kernels of another path launched "
                             f"{stray}: {launches}")


def profile_steps(step, steps: int, med_ms: float, smi: str) -> dict:
    """Device time by kernel over `steps` calls of step() in a
    torch.profiler window, and the device idle share against the
    unprofiled median step med_ms (the profiler slows the host)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # device-side kernel records only: an op's record, or a user
        # annotation such as the optimizer step's, carries its kernels'
        # time a second time
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)
                or "#" in evt.key):
            continue
        dt = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if dt > 0:
            rows.append((dt / 1e3 / steps, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"steps": steps, "wall_ms_per_step": window_ms / steps,
            "device_ms_per_step": busy,
            "device_idle_share": 1.0 - busy / med_ms,
            "top": [{"ms_per_step": round(t, 4), "name": n[:80],
                     "calls": c} for t, n, c in rows[:14]], "card": smi}


def full_batch_phase(ds, packed, row_valid, smi: str) -> dict:
    """Phase 5: the packed full-batch flagship, imputation, scoring and a
    profile window. Returns its launch counts."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.data import simulate_irt
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.serve import AbilityScorer
    from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer

    model = VIBO(flagship_config())
    trainer = Trainer(model, TrainConfig(lr=5e-3, max_grad_norm=10.0))
    params = model.init_params(0)
    optimizer = make_optimizer(params, 5e-3)
    noise = torch.Generator(device="cuda")
    noise.manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    step_ms, auxs = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        auxs.append(trainer.step(params, optimizer, packed, row_valid, noise))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    check_path("full-batch path", launches, FULL_BATCH_KERNELS,
               MINIBATCH_KERNELS)
    elbos = [float(a["elbo"]) for a in auxs]
    if not np.isfinite(elbos).all():
        raise AssertionError(f"non-finite ELBO in the full-batch path: "
                             f"{elbos}")
    if not np.mean(elbos[-5:]) > np.mean(elbos[:5]):
        raise AssertionError(f"ELBO did not rise: {elbos}")
    med = statistics.median(step_ms[3:])
    emit({"phase": "train", "steps": STEPS, "step_ms_median": med,
          "step_ms_first": step_ms[0], "cells_per_s": B * M / (med / 1e3),
          "elbo_first": elbos[0], "elbo_last": elbos[-1],
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})

    t0 = time.perf_counter()
    ev = evaluation.imputation_accuracy(model, params, ds)
    if not (ev["num_heldout"] > 0 and 0.0 <= ev["acc"] <= 1.0):
        raise AssertionError(f"bad imputation result {ev}")
    emit({"phase": "imputation", **ev,
          "seconds": time.perf_counter() - t0})

    fresh = simulate_irt("2pl", 256, M, ability_dim=K, seed=1,
                         missing_rate=0.1)
    t0 = time.perf_counter()
    out = AbilityScorer(model, params).score(fresh.response, fresh.mask)
    score_s = time.perf_counter() - t0
    shapes = {k: list(v.shape) for k, v in out.items()}
    if shapes != {"theta_mu": [256, K], "theta_sigma": [256, K],
                  "prob": [256, M]}:
        raise AssertionError(f"scorer shapes {shapes}")
    if not (all(np.isfinite(v).all() for v in out.values())
            and (out["theta_sigma"] > 0).all()
            and ((out["prob"] > 0) & (out["prob"] < 1)).all()):
        raise AssertionError("scorer output out of range")
    emit({"phase": "score", "rows": 256, "seconds": score_s,
          "theta_mu_std": float(out["theta_mu"].std())})

    emit({"phase": "profile", **profile_steps(
        lambda: trainer.step(params, optimizer, packed, row_valid, noise),
        10, med, smi)})
    return launches


def minibatch_phase(ds, smi: str) -> dict:
    """Phases 6 and 7: minibatch ELBO training through Trainer.fit, the
    fit's host work (batch slicing, copy to the card) timed on its own, IWAE
    steps, step times and a profile window on device-resident batches, and
    the held-out IWAE-100 bound. Returns the launch counts of the fit and
    the IWAE steps together, in all and by the masked loglik's reader."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.data import batch_iterator
    from vibo_tpu_torch.models import VIBO
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.train import Trainer, TrainConfig

    model = VIBO(flagship_config())
    item_scale = BATCH / B
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = Trainer(model, TrainConfig(lr=5e-3, epochs=EPOCHS,
                                     batch_size=BATCH, eval_every=EPOCHS,
                                     seed=0)).fit(ds)
    fit_s = time.perf_counter() - t0
    fit_launches, fit_readers = launch_counts(), reader_counts()
    check_path("minibatch path", fit_launches, MINIBATCH_KERNELS,
               FULL_BATCH_KERNELS)
    check_dense_only("minibatch path", fit_readers)
    epoch_elbo = [h["elbo"] for h in res["history"] if h["event"] == "train"]
    steps = EPOCHS * -(-B // BATCH)
    if not (len(epoch_elbo) == EPOCHS and np.isfinite(epoch_elbo).all()):
        raise AssertionError(f"minibatch epoch ELBOs {epoch_elbo}")
    if not epoch_elbo[-1] > epoch_elbo[0]:
        raise AssertionError(f"minibatch ELBO did not rise: {epoch_elbo}")
    if fit_launches["masked_loglik_2pl_fwd"] != steps:
        raise AssertionError(f"{steps} steps, {fit_launches} launches")
    emit({"phase": "minibatch_train", "epochs": EPOCHS, "steps": steps,
          "batch_size": BATCH, "epoch_elbo": epoch_elbo,
          "fit_seconds": fit_s, "train_seconds": res["train_seconds"],
          "cells_per_s": res["cells_per_sec"],
          "heldout_acc": res["best"]["heldout_acc"],
          "launches": fit_launches, "launches_by_reader": fit_readers,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": smi})

    # the fit's host work alone, the same epochs' batches: batch_iterator's
    # row slicing and padding, then the pageable copy of each to the card
    slice_ms, copy_ms = [], []
    for epoch in range(EPOCHS):
        it = batch_iterator(ds, BATCH, 0, epoch)
        while True:
            t0 = time.perf_counter()
            bm = next(it, None)
            if bm is None:
                break
            slice_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x in bm:
                torch.from_numpy(x).to("cuda")
            torch.cuda.synchronize()
            copy_ms.append((time.perf_counter() - t0) * 1e3)
    # means, as fit's step is its mean (the padded batch slices faster)
    host = {"fit_step_ms": res["train_seconds"] * 1e3 / steps,
            "slice_ms_mean": statistics.mean(slice_ms),
            "copy_ms_mean": statistics.mean(copy_ms),
            "slice_ms": slice_ms, "copy_ms": copy_ms}

    params, optimizer = res["params"], res["optimizer"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batches = [tuple(torch.from_numpy(x).cuda() for x in bm)
               for bm in batch_iterator(ds, BATCH, 0, EPOCHS)]
    iwae = Trainer(model, TrainConfig(lr=5e-3, batch_size=BATCH,
                                      objective="iwae",
                                      num_mc_samples=IWAE_S))
    _build.reset_launches()
    bounds = [float(iwae.minibatch_step(params, optimizer, r, m_,
                                        item_scale, gen)["elbo"])
              for r, m_ in batches[:IWAE_STEPS]]
    iwae_launches, iwae_readers = launch_counts(), reader_counts()
    check_path("IWAE steps", iwae_launches, MINIBATCH_KERNELS,
               FULL_BATCH_KERNELS)
    check_dense_only("IWAE steps", iwae_readers)
    if not np.isfinite(bounds).all():
        raise AssertionError(f"non-finite IWAE training bound {bounds}")
    emit({"phase": "iwae_train", "steps": IWAE_STEPS, "samples": IWAE_S,
          "bounds": bounds, "launches": iwae_launches,
          "launches_by_reader": iwae_readers})

    # step time on device-resident batches (ELBO), 3 epochs' worth
    elbo = Trainer(model, TrainConfig(lr=5e-3, batch_size=BATCH))
    step_ms = []
    for i in range(9):
        r, m_ = batches[i % len(batches)]
        t0 = time.perf_counter()
        elbo.minibatch_step(params, optimizer, r, m_, item_scale, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(step_ms[1:])
    # the fit's step against its parts measured here: host slicing, copy,
    # and the step on device-resident batches; the rest is what these do
    # not cover (the first epoch's warm-up among it)
    fit_ms = host["fit_step_ms"]
    parts = {"slice": host["slice_ms_mean"], "copy": host["copy_ms_mean"],
             "device_resident_step": statistics.mean(step_ms[1:])}
    host["share_of_fit_step"] = {
        **{k: v / fit_ms for k, v in parts.items()},
        "rest": 1.0 - sum(parts.values()) / fit_ms}
    # true cells: an epoch of len(batches) steps covers the B * M matrix
    emit({"phase": "minibatch_step", "step_ms_median": med,
          "step_ms": step_ms,
          "cells_per_s": B * M / (med * len(batches) / 1e3),
          "fit_host": host, "card": smi})
    cycle = itertools.cycle(batches)
    emit({"phase": "minibatch_profile", **profile_steps(
        lambda: elbo.minibatch_step(params, optimizer, *next(cycle),
                                    item_scale, gen), 6, med, smi)})

    t0 = time.perf_counter()
    ev = evaluation.iwae_loglik(model, params, ds, num_samples=100,
                                on="heldout", generator=gen)
    torch.cuda.synchronize()
    iwae_s = time.perf_counter() - t0
    if not (np.isfinite(ev["loglik_per_cell"]) and ev["loglik_per_cell"] < 0
            and ev["num_cells"] > 0):
        raise AssertionError(f"bad held-out IWAE-100 {ev}")
    emit({"phase": "iwae_heldout", **ev, "seconds": iwae_s, "card": smi})
    readers = {n: {v: fit_readers[n].get(v, 0) + iwae_readers[n].get(v, 0)
                   for v in ("dense", "int8")} for n in MINIBATCH_KERNELS}
    return ({n: fit_launches[n] + iwae_launches[n] for n in fit_launches},
            readers)


def flagship_config():
    from vibo_tpu_torch.models import VIBOConfig
    return VIBOConfig(num_items=M, irt_model="2pl", ability_dim=K,
                      hidden_dim=H, conditional_posterior=True,
                      condition_on="sample", use_pallas=True,
                      compute_dtype="bfloat16")


def kernel_entry(name, replaces, source, launches, r, **extra) -> dict:
    """One entry of the kernels line; r holds the kernel check's numbers."""
    return {"name": name, "route": "cuda",
            "source": f"vibo_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches,
            **{k: v for k, v in r.items() if k != "rel_err"}, **extra}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    from vibo_tpu_torch._device import resolve_device
    from vibo_tpu_torch.data import batch_iterator, holdout_split, simulate_irt
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.ops.packing import packed_on_device

    resolve_device(None)           # the card, with TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {s: [ln.strip() for ln in open(v["log"]).read().splitlines()
                 if "registers" in ln or "spill" in ln]
             for s, v in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": {s: v["seconds"] for s, v in built.items()},
          "ptxas": ptxas})

    t0 = time.perf_counter()
    sim = simulate_irt("2pl", B, M, ability_dim=K, seed=0, missing_rate=0.1)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0)
    packed, row_valid = packed_on_device(ds.response, ds.train_mask)
    # epoch 0's first batch, and its last, padded with all-zero rows
    epoch0 = list(batch_iterator(ds, BATCH, 0, 0))
    resp_mb, mask_mb = (torch.from_numpy(x).cuda() for x in epoch0[0])
    resp_pad, mask_pad = (torch.from_numpy(x).cuda() for x in epoch0[-1])
    pad_rows = int((mask_pad.sum(-1) == 0).sum())
    if pad_rows != len(epoch0) * BATCH - B:
        raise AssertionError(f"last batch has {pad_rows} empty rows")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "shape": [B, M], "observed_train_frac":
          float(ds.train_mask.mean())})

    timer = Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = {}
    ragged_pk = torch.randint(0, 3, RAGGED, generator=gen, device="cuda",
                              dtype=torch.int8)
    for shape, pk in (("flagship", packed), ("ragged", ragged_pk)):
        timed = shape == "flagship"
        fl = check_first_layer(timer, pk, gen, timed)
        ll = check_loglik(timer, pk, gen, timed)
        checks[shape] = {**fl, "loglik_2pl_train": ll}
        emit({"phase": "kernel_check", "shape": shape,
              "dims": list(pk.shape) + [K, H], "results": checks[shape],
              "card": smi})
    ragged_m = (ragged_pk > 0).float()
    ragged_r = (ragged_pk == 2).float()
    # M = 301: rows off the vector boundary take the scalar reader
    odd_pk = torch.randint(0, 3, ODD, generator=gen, device="cuda",
                           dtype=torch.int8)
    odd_m, odd_r = (odd_pk > 0).float(), (odd_pk == 2).float()
    masked = {
        "minibatch": check_masked(timer, resp_mb, mask_mb, gen, True),
        # the IWAE steps' call: S samples, per-sample a and b, shared data
        f"minibatch_S{IWAE_S}": check_masked(timer, resp_mb, mask_mb, gen,
                                             False, samples=IWAE_S),
        "minibatch_padded": check_masked(timer, resp_pad, mask_pad, gen,
                                         False),
        "ragged": check_masked(timer, ragged_r, ragged_m, gen, False),
        "ragged_S2": check_masked(timer, ragged_r, ragged_m, gen, False,
                                  samples=2),
        "ragged_S3_shared_items": check_masked(timer, ragged_r, ragged_m,
                                               gen, False, samples=3,
                                               shared_items=True),
        "odd_K1_S2": check_masked(timer, odd_r, odd_m, gen, False,
                                  samples=2, k=1),
        "odd_K8": check_masked(timer, odd_r, odd_m, gen, False, k=8),
    }
    emit({"phase": "kernel_check", "kernel": "masked_loglik_2pl",
          "dims": {"minibatch": [BATCH, M, K], "padded_rows": pad_rows,
                   "ragged": list(RAGGED) + [K],
                   "odd": list(ODD)}, "results": masked, "card": smi})

    emit({"phase": "objective_vs_cpu",
          "packed_max_rel_err": objective_matches_cpu(decoded=False),
          "decoded_max_rel_err": objective_matches_cpu(decoded=True)})

    full = full_batch_phase(ds, packed, row_valid, smi)
    mini, mini_readers = minibatch_phase(ds, smi)

    fl, ll = checks["flagship"], checks["flagship"]["loglik_2pl_train"]
    mb = masked["minibatch"]
    int8_note = ("int8 reader: on no model path, so checked and timed in "
                 "kernel_check; launches are its count over the minibatch "
                 "fit and the IWAE steps")
    kernels = [
        kernel_entry("first_layer_fwd", "vibo_tpu/ops/pallas_encoder.py:142",
                     "first_layer.cu", full["first_layer_fwd"],
                     fl["first_layer_fwd"]),
        kernel_entry("first_layer_bwd", "vibo_tpu/ops/pallas_encoder.py:167",
                     "first_layer.cu", full["first_layer_bwd"],
                     fl["first_layer_bwd"]),
        kernel_entry("loglik_2pl_train", "vibo_tpu/ops/pallas_elbo.py:1244 "
                     "(and :613, the (B, K) layout)", "loglik_2pl.cu",
                     full["loglik_2pl_train"], ll["kb"],
                     bk_layout=ll["bk"]),
    ]
    for direction, line, int8_line in (("fwd", 247, 445), ("bwd", 319, 468)):
        name = f"masked_loglik_2pl_{direction}"
        int8 = {k: v for k, v in mb["int8"][direction].items()
                if k != "rel_err"}
        kernels.append(kernel_entry(
            name, f"vibo_tpu/ops/pallas_elbo.py:{line} (dense reader; int8 "
            f"reader :{int8_line})", "masked_loglik_2pl.cu", mini[name],
            mb["dense"][direction],
            int8_reader={**int8, "launches": mini_readers[name]["int8"],
                         "note": int8_note},
            launches_by_reader=mini_readers[name]))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
