"""Smoke run of the PyTorch/CUDA port (`vibo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises (non-zero exit):
  1. device: a CUDA card is required (no CPU fallback);
  2. build: nvcc compiles every csrc/*.cu of the port, in parallel;
  3. kernel checks: each hand-written kernel against its plain PyTorch
     version on the card, at the flagship shapes (10,240 students x 1,024
     items, K=4, hidden 256) and at a ragged shape, with CUDA-event times of
     the kernel, the plain version and, where one PyTorch call computes the
     same function, that call (timed only, never used by the port);
  4. main path: the 2PL flagship (bf16 encoder, conditional posterior,
     transposed theta) trains >= 30 full-batch steps through Trainer.step
     with every kernel's launch counter read around them; a small-shape
     check holds the objective and its gradients on the card against the
     CPU path; then held-out imputation accuracy and AbilityScorer.score on
     fresh students;
  5. a torch.profiler window of a few steps: device time by kernel.
Then the kernels summary line, the card's name and power limit, and the
final status line {"ok": true, "device": {...}}.

Bounds use the H100 SXM's published peaks: 3.35 TB/s of HBM, 989 TFLOP/s
bf16 on the tensor cores, 67 TFLOP/s f32 outside them.
"""

from __future__ import annotations

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
RAGGED = (1000, 300)                      # students, items: edge masking
STEPS = 40


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


def objective_matches_cpu() -> float:
    """The objective and every gradient at a small shape on the card
    (kernels) against the CPU (plain versions), same params and noise; bf16
    encoder, so 1e-2 of each array's largest magnitude (a bf16 rounding of
    dh may flip between the two)."""
    from vibo_tpu_torch.convert import (params_from_jax, params_to_numpy,
                                        tree_leaves)
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    from vibo_tpu_torch.ops import objectives
    from vibo_tpu_torch.ops.packing import packed_on_device
    n, m = 300, 200
    rng = np.random.default_rng(3)
    resp = (rng.random((n, m)) < 0.5).astype(np.float32)
    mask = (rng.random((n, m)) < 0.9).astype(np.float32)
    cfg = VIBOConfig(num_items=m, irt_model="2pl", ability_dim=K,
                     hidden_dim=64, use_pallas=True, compute_dtype="bfloat16")
    params_np = params_to_numpy(VIBO(cfg, device="cpu").init_params(7))
    item_eps = {"a": rng.standard_normal((1, m, K)).astype(np.float32),
                "b": rng.standard_normal((1, m, 1)).astype(np.float32)}
    theta_eps = rng.standard_normal((1, K, n)).astype(np.float32)
    results = []
    for dev in ("cuda", "cpu"):
        model = VIBO(cfg, device=dev)
        params = params_from_jax(params_np, dev)
        packed, rv = packed_on_device(resp, mask, dev)
        terms = model.elbo_packed_sums(
            params, packed,
            {k: torch.from_numpy(v).to(dev) for k, v in item_eps.items()},
            torch.from_numpy(theta_eps).to(dev), rv, transposed=True)
        objectives.elbo(*terms).backward()
        results.append([t.detach().cpu() for t in terms]
                       + [p.grad.cpu() for p in tree_leaves(params)])
    worst = max(rel_err(g, c) for g, c in zip(*results))
    if not worst <= 1e-2:
        raise AssertionError(f"objective on the card disagrees with the "
                             f"CPU path: {worst}")
    return worst


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch._device import resolve_device
    from vibo_tpu_torch.data import holdout_split, simulate_irt
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    from vibo_tpu_torch.ops import _build
    from vibo_tpu_torch.ops.packing import packed_on_device
    from vibo_tpu_torch.serve import AbilityScorer
    from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer

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
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "shape": [B, M], "observed_train_frac":
          float(ds.train_mask.mean())})

    timer = Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = {}
    for shape, pk in (("flagship", packed),
                      ("ragged", torch.randint(0, 3, RAGGED, generator=gen,
                                               device="cuda",
                                               dtype=torch.int8))):
        timed = shape == "flagship"
        fl = check_first_layer(timer, pk, gen, timed)
        ll = check_loglik(timer, pk, gen, timed)
        checks[shape] = {**fl, "loglik_2pl_train": ll}
        emit({"phase": "kernel_check", "shape": shape,
              "dims": list(pk.shape) + [K, H], "results": checks[shape],
              "card": smi})

    worst = objective_matches_cpu()
    emit({"phase": "objective_vs_cpu", "max_rel_err": worst})

    cfg = VIBOConfig(num_items=M, irt_model="2pl", ability_dim=K,
                     hidden_dim=H, conditional_posterior=True,
                     condition_on="sample", use_pallas=True,
                     compute_dtype="bfloat16")
    model = VIBO(cfg)
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
    launches = {name: k.launches for name, k in _build.KERNELS.items()}
    elbos = [float(a["elbo"]) for a in auxs]
    if not np.isfinite(elbos).all():
        raise AssertionError(f"non-finite ELBO in the main path: {elbos}")
    if not np.mean(elbos[-5:]) > np.mean(elbos[:5]):
        raise AssertionError(f"ELBO did not rise: {elbos}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
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

    # device time by kernel over a few steady steps
    prof_steps = 10
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(prof_steps):
            trainer.step(params, optimizer, packed, row_valid, noise)
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
            rows.append((dt / 1e3 / prof_steps, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    emit({"phase": "profile", "steps": prof_steps,
          "wall_ms_per_step": window_ms / prof_steps,
          "device_ms_per_step": busy,
          # against the unprofiled median step: the profiler slows the host
          "device_idle_share": 1.0 - busy / med,
          "top": [{"ms_per_step": round(t, 4), "name": n[:80],
                   "calls": c} for t, n, c in rows[:14]], "card": smi})

    fl, ll = checks["flagship"], checks["flagship"]["loglik_2pl_train"]
    kernels = [
        {"name": "first_layer_fwd", "route": "cuda",
         "source": "vibo_tpu_torch/csrc/first_layer.cu",
         "replaces": "vibo_tpu/ops/pallas_encoder.py:142",
         "launches": launches["first_layer_fwd"], **fl["first_layer_fwd"]},
        {"name": "first_layer_bwd", "route": "cuda",
         "source": "vibo_tpu_torch/csrc/first_layer.cu",
         "replaces": "vibo_tpu/ops/pallas_encoder.py:167",
         "launches": launches["first_layer_bwd"], **fl["first_layer_bwd"]},
        {"name": "loglik_2pl_train", "route": "cuda",
         "source": "vibo_tpu_torch/csrc/loglik_2pl.cu",
         "replaces": "vibo_tpu/ops/pallas_elbo.py:1244 "
                     "(and :613, the (B, K) layout)",
         "launches": launches["loglik_2pl_train"], **ll["kb"],
         "bk_layout": ll["bk"]},
    ]
    for kern in kernels:
        kern.pop("rel_err", None)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
