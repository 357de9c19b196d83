"""Gloo CPU ranks for the port's mesh tests, without JAX.

`run_world(world, jobs)` spawns `world` processes (torch.multiprocessing,
start method spawn, a torch.distributed FileStore in a temporary folder),
each on one CPU thread. Every rank runs every job of `jobs` in order on the
port alone (this module and the ranks import vibo_tpu_torch, never JAX) and
the results come back as results[rank][job]. A job names its kind (JOBS)
and the mesh it runs on: `ranks` (a subset of the world, default all of
it) and `item_axis`; a rank outside the mesh returns None for it. Inputs
are numpy (JAX's params and noise, made by the test in its own process).
"""

from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 120                      # a collective that waits this long fails


def run_world(world: int, jobs: list) -> list:
    """Run `jobs` on `world` gloo ranks -> results[rank][job]."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        mp.start_processes(_rank_main, args=(world, d), nprocs=world,
                           join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def _rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from vibo_tpu_torch.parallel import make_mesh
    with open(os.path.join(d, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    meshes, out = {}, []
    for job in jobs:
        key = (tuple(job.get("ranks", range(world))), job.get("item_axis", 1))
        if key not in meshes:
            meshes[key] = make_mesh(key[1], device="cpu", ranks=key[0])
        mesh = meshes[key]
        out.append(None if mesh is None else JOBS[job["kind"]](mesh, job))
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def digest(params) -> str:
    """A digest of a param tree's bytes (tree_leaves order)."""
    from vibo_tpu_torch.convert import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _numpy(params) -> dict:
    from vibo_tpu_torch.convert import params_to_numpy
    return params_to_numpy(params)


def _torch_noise(noise):
    item, theta = noise
    return ({k: torch.from_numpy(np.asarray(v)) for k, v in item.items()},
            torch.from_numpy(np.asarray(theta)))


def _model_trainer(mesh, job):
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    from vibo_tpu_torch.train import Trainer, TrainConfig
    model = VIBO(VIBOConfig(**job["config"]), device="cpu")
    return model, Trainer(model, TrainConfig(**job.get("train", {})),
                          mesh=mesh)


def shapes_job(mesh, job) -> dict:
    """make_mesh over the whole world at each item_axis of the job: the
    shape, this rank's coordinates and its groups' sizes; the error of an
    item_axis that does not divide the world; the device make_mesh takes
    when none is named (the card, or its error where there is none: never
    the CPU because the backend is gloo)."""
    from vibo_tpu_torch.parallel import group_size, make_mesh
    out = {}
    try:
        out["default_device"] = str(make_mesh(1).device)
    except RuntimeError as e:
        out["default_device"] = str(e)
    for axis in job["axes"]:
        try:
            m = make_mesh(axis, device="cpu")
        except ValueError as e:
            out[axis] = str(e)
            continue
        out[axis] = {"shape": dict(m.shape), "ranks": m.ranks,
                     "rank": m.rank, "student_index": m.student_index,
                     "item_index": m.item_index,
                     "sizes": (group_size(m.students), group_size(m.items),
                               group_size(m.world))}
    return out


def _tile(mesh, x: np.ndarray, rows: int, cols: bool) -> torch.Tensor:
    """The rank's rows (padded with zero rows) and, when cols, its item
    block of a host array."""
    lo, hi = mesh.student_rows(rows)
    out = x[lo:hi]
    if out.shape[0] < hi - lo:
        out = np.concatenate([out, np.zeros((hi - lo - out.shape[0],)
                                            + x.shape[1:], x.dtype)])
    if cols:
        c0, c1 = mesh.item_block(x.shape[1])
        out = out[:, c0:c1]
    return torch.from_numpy(np.ascontiguousarray(out))


def step_job(mesh, job) -> dict:
    """One step on the mesh from the job's params and whole noise: the
    packed step (JAX's _dp_raw_step / _dp2d_raw_step) on the rank's tile of
    job["packed"], or with job["decoded"] the decoded step on its rows of
    (response, mask); SGD at job["lr"], clip off unless the job's train
    config sets it. Returns the params after, the
    last step's gradients (tree_leaves order; summed over the mesh), the
    aux and the params' digest."""
    from vibo_tpu_torch.convert import params_from_jax, tree_leaves
    _, trainer = _model_trainer(mesh, job)
    params = params_from_jax(job["params"], "cpu")
    leaves = tree_leaves(params)
    optimizer = torch.optim.SGD(leaves, lr=job["lr"])
    rows = job["rows"]
    auxs = []
    for noise in job["noise"]:
        if job.get("decoded"):
            resp, mask = (_tile(mesh, x, rows, False)
                          for x in job["decoded"])
            noise = trainer._rank_noise(_torch_noise(noise), rows, False)
            aux = trainer.minibatch_step_with_noise(
                params, optimizer, resp, mask, *noise, job["item_scale"])
        else:
            two_d = mesh.num_items > 1
            pk = _tile(mesh, job["packed"], rows, two_d)
            rv = _tile(mesh, job["row_valid"], rows, False)
            tp = trainer._theta_transposed()
            noise = trainer._rank_noise(_torch_noise(noise), rows, tp)
            aux = trainer.step_with_noise(params, optimizer, pk, rv, *noise,
                                          job["item_scale"])
        auxs.append({k: float(v) for k, v in aux.items()})
    return {"params": _numpy(params) if mesh.rank == 0 else None,
            "grads": [p.grad.numpy() for p in leaves] if mesh.rank == 0
            else None, "aux": auxs, "digest": digest(params)}


def _dataset(job):
    from vibo_tpu_torch.data.masking import Dataset
    return Dataset(*job["ds"], num_categories=job.get("categories", 2))


def fit_job(mesh, job) -> dict:
    """Trainer(mesh).fit on the job's dataset (resuming job["resume"] where
    given): history, final ELBO, best, the params (mesh rank 0) and their
    digest; a ValueError's message instead where the fit raises one.
    out_dir: this rank's listing of it after the fit."""
    _, trainer = _model_trainer(mesh, job)
    try:
        res = trainer.fit(_dataset(job), resume=job.get("resume"))
    except ValueError as e:
        return {"error": str(e)}
    out = {"history": [{k: v for k, v in h.items() if k != "cells_per_sec"}
                       for h in res["history"]],
           "final_elbo": res["final_elbo"], "best": res["best"],
           "params": _numpy(res["params"]) if mesh.rank == 0 else None,
           "digest": digest(res["params"])}
    out_dir = job.get("train", {}).get("out_dir")
    if out_dir:
        out["out_dir"] = sorted(os.listdir(out_dir))
    return out


def eval_job(mesh, job) -> dict:
    """The sharded evaluators on the job's params and dataset:
    imputation_accuracy_sharded, calibration_sharded and
    iwae_loglik_sharded (on the job's noise, or drawn from a generator
    seeded with job["seed"])."""
    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch.convert import params_from_jax
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    model = VIBO(VIBOConfig(**job["config"]), device="cpu")
    params = params_from_jax(job["params"], "cpu")
    ds = _dataset(job)
    out = {"impute": evaluation.imputation_accuracy_sharded(
               model, params, ds, mesh),
           "calibration": evaluation.calibration_sharded(
               model, params, ds, mesh)}
    gen = torch.Generator().manual_seed(job.get("seed", 0))
    noise = (None if job.get("noise") is None
             else _torch_noise(job["noise"]))
    for on in ("heldout", "train"):
        out[f"iwae_{on}"] = evaluation.iwae_loglik_sharded(
            model, params, ds, mesh, job["samples"], on=on,
            generator=gen if noise is None else None, noise=noise)
    return out


JOBS = {"shapes": shapes_job, "step": step_job, "fit": fit_job,
        "eval": eval_job}
