"""Six-figure-student pipeline on one card (counterpart of the repo's
`scripts/run_at_scale.py`: the same flags, defaults and JSON keys):

  1. write (if absent) a DuoLingo-shaped CSV (`gen_duolingo_csv`: 13 M rows,
     140,000 users x 2,048 lexemes, 2PL draws), in process;
  2. ingest it with the native C++ parser through
     `load_dataset("duolingo", data_dir=...)` (a parser that cannot be built
     raises: no Python parse of 13 M rows);
  3. hold out a slice of PERSONS entirely (`split_persons`);
  4. train packed full-batch 2PL VIBO on the remaining students: the int8
     code on the card, S samples a step, `Trainer.make_scan` chunks (one
     CUDA graph of `chunk` steps, one replay a chunk), bf16 first layer;
  5. evaluate: blocked held-out imputation accuracy, IWAE held-out
     log-likelihood (16,384-person blocks) and amortized NEW-person scoring
     (one encoder pass, no optimization) of the held-out students;
  6. report the step time (CUDA events over the timed chunks), cells/s,
     the host's chunk overhead and the card's peak and resident memory.

Timing protocol: one chunk from the initial state (the capture and a
replay), then one chunk timed from it again, then `epochs` trained from it
once more, as the reference does with immutable params. The fused steps
train in place and their graph binds the params', Adam's and the
generator's addresses, so the initial state is put back in place between
the three.

Prints ONE JSON line last. Progress goes to stderr.

  python -m vibo_tpu_torch.scripts.run_at_scale           # 13 M rows
  python -m vibo_tpu_torch.scripts.run_at_scale --rows 2000000 --users 30000
  python -m vibo_tpu_torch.scripts.run_at_scale --cpu --rows 150000 \\
      --users 3000 --lexemes 128 --hidden-dim 64 --num-samples 2 \\
      --epochs 300 --iwae-samples 10

The CSV goes to `--csv`, by default under the repo's git-ignored `build/`
in a folder named by its rows, users, lexemes and seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vibo_tpu_torch import evaluation
from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.data import native
from vibo_tpu_torch.data.loaders import load_dataset
from vibo_tpu_torch.data.masking import split_persons
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops.packing import pack_responses
from vibo_tpu_torch.scripts.gen_duolingo_csv import generate
from vibo_tpu_torch.train import Trainer, TrainConfig, make_optimizer
from vibo_tpu_torch.train.trainer import _restore, _snapshot

CSV_ROOT = Path(__file__).resolve().parents[2] / "build" / "duo_data"


def default_csv(rows: int, users: int, lexemes: int, seed: int) -> str:
    """The CSV's path under build/ for these generator arguments."""
    return str(CSV_ROOT / f"r{rows}_u{users}_l{lexemes}_s{seed}"
               / "duolingo.csv")


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU; the torch name where nvidia-smi is missing)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def write_csv(path: str, rows: int, users: int, lexemes: int,
              seed: int) -> float | None:
    """Generate the CSV at path unless it exists (through a temporary name,
    so a cut run leaves no partial file behind) -> seconds, None if it
    existed."""
    if os.path.exists(path):
        return None
    _log(f"generating {rows}-row CSV at {path} ...")
    t0 = time.perf_counter()
    tmp = f"{path}.{os.getpid()}.tmp"
    generate(tmp, rows, users, lexemes, seed)
    os.replace(tmp, path)
    return time.perf_counter() - t0


def ingest(csv: str, rows: int, users: int, lexemes: int, seed: int,
           new_person_frac: float) -> tuple:
    """Steps 1-3: write the CSV if missing, ingest it through the native
    parser (raises where it cannot be built), split the persons -> (train
    Dataset, new-person Dataset, {"csv_write_s", "ingest_s"})."""
    csv_write_s = write_csv(csv, rows, users, lexemes, seed)
    if not native.available():
        raise RuntimeError(f"the native CSV parser could not be built from "
                           f"{native.SOURCE}; the at-scale run does not "
                           "parse its CSV in Python")
    t0 = time.perf_counter()
    ds = load_dataset("duolingo", data_dir=os.path.dirname(csv),
                      holdout_frac=0.1, seed=seed)
    ingest_s = time.perf_counter() - t0
    n_all, m = ds.response.shape
    _log(f"ingested {n_all} x {m} in {ingest_s:.1f} s "
         f"({int(ds.train_mask.sum() + ds.heldout_mask.sum())} observed)")
    # the held-out students never touch training
    train_ds, new_ds = split_persons(ds, test_frac=new_person_frac,
                                     seed=seed)
    return train_ds, new_ds, {"csv_write_s": csv_write_s,
                              "ingest_s": ingest_s}


def training_state(train_ds, hidden_dim: int, seed: int,
                   dev: torch.device) -> dict:
    """Step 4's model and state: the 2PL VIBO (K = 1, bf16 first layer,
    the kernels on), its Trainer (lr 5e-3), params from `seed`, Adam, and
    the int8 code and row validity on `dev`."""
    model = VIBO(VIBOConfig(num_items=train_ds.response.shape[1],
                            irt_model="2pl", ability_dim=1,
                            hidden_dim=hidden_dim, use_pallas=True,
                            compute_dtype="bfloat16"), device=dev)
    trainer = Trainer(model, TrainConfig(lr=5e-3), device=dev)
    params = model.init_params(seed)
    return {"model": model, "trainer": trainer, "params": params,
            "optimizer": make_optimizer(params, trainer.cfg.lr),
            "code": torch.from_numpy(pack_responses(
                train_ds.response, train_ds.train_mask)).to(dev),
            "row_valid": torch.from_numpy(
                (train_ds.train_mask.sum(-1) > 0).astype(np.float32)
            ).to(dev)}


def run(csv: str | None = None, rows: int = 13_000_000,
        users: int = 140_000, lexemes: int = 2048, epochs: int = 1500,
        chunk: int = 100, hidden_dim: int = 256, num_samples: int = 5,
        new_person_frac: float = 0.03, iwae_samples: int = 100,
        seed: int = 0, device=None, after_train=None) -> dict:
    """The pipeline (module doc) -> the JSON line's dict. device None is
    the card (raises without one). after_train(state, out), if given, runs
    after the timed training and before the evaluation, with state the
    trainer, scan, params, optimizer, code, row_valid and generator: what
    it trains it must put back (the smoke profiles a chunk there)."""
    dev = resolve_device(device)
    csv = csv or default_csv(rows, users, lexemes, seed)
    train_ds, new_ds, host = ingest(csv, rows, users, lexemes, seed,
                                    new_person_frac)
    n, m = train_ds.response.shape

    # -- 4. packed full-batch training on one card ---------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    st = training_state(train_ds, hidden_dim, seed, dev)
    model, trainer, params, optimizer, code, row_valid = (
        st[k] for k in ("model", "trainer", "params", "optimizer", "code",
                        "row_valid"))
    scan = trainer.make_scan(1.0, num_samples, chunk)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    initial = _snapshot(params, optimizer, gen)

    def steps(n_chunks: int) -> list:
        elbos = []
        for _ in range(n_chunks):
            aux = scan(params, optimizer, code, row_valid, gen)
            elbos.append(float(aux[-1, 0]))   # waits for the chunk
        return elbos

    # the first chunk captures the graph; then one chunk timed from the
    # initial state, then the run from it (module doc)
    t0 = time.perf_counter()
    steps(1)
    first_chunk_s = time.perf_counter() - t0
    _restore(initial, params, optimizer, gen)
    t0 = time.perf_counter()
    steps(1)
    t_one_chunk = time.perf_counter() - t0
    _restore(initial, params, optimizer, gen)
    gen.manual_seed(seed + 1)

    n_chunks = max(1, epochs // chunk)
    n_epochs = n_chunks * chunk
    _sync(dev)
    events = None
    if dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
    t0 = time.perf_counter()
    chunk_elbos = steps(n_chunks)
    train_s = time.perf_counter() - t0
    per_step_host = train_s / n_epochs
    if events is not None:
        events[1].record()
        _sync(dev)
        per_step = events[0].elapsed_time(events[1]) / 1e3 / n_epochs
    else:
        per_step = per_step_host
    cells_per_s = n * m / per_step
    peak = resident = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        resident = torch.cuda.memory_allocated(dev) / 1e9
    _log(f"trained {n_epochs} full-batch epochs on {n} x {m} in "
         f"{train_s:.1f} s ({per_step * 1e3:.2f} ms/epoch, "
         f"{cells_per_s:.3e} cells/s, peak {peak} GB, resident "
         f"{resident} GB)")
    out = {
        "csv": csv,
        "persons_train": int(n),
        "persons_new": int(new_ds.response.shape[0]),
        "items": int(m),
        "observed_cells": int(train_ds.train_mask.sum()),
        "ingest_s": host["ingest_s"],
        "epochs": n_epochs,
        "train_s": train_s,
        "ms_per_epoch": per_step * 1e3,
        "cells_per_s": cells_per_s,
        "chunk_overhead_s": max(0.0, t_one_chunk - per_step_host * chunk),
        "peak_hbm_gb": peak,
        "resident_device_gb": resident,
        "final_elbo": chunk_elbos[-1],
    }
    if after_train is not None:
        after_train({"trainer": trainer, "scan": scan, "params": params,
                     "optimizer": optimizer, "code": code,
                     "row_valid": row_valid, "generator": gen}, out)

    # -- 5. evaluation (everything block-streamed) ---------------------------
    t0 = time.perf_counter()
    acc = evaluation.imputation_accuracy(model, params, train_ds)
    impute_s = time.perf_counter() - t0

    iwae_gen = torch.Generator(device=dev)
    iwae_gen.manual_seed(7)
    t0 = time.perf_counter()
    iwae = evaluation.iwae_loglik(model, params, train_ds,
                                  num_samples=iwae_samples,
                                  generator=iwae_gen)
    iwae_s = time.perf_counter() - t0

    new_person = evaluation.amortized_new_person_eval(model, params, new_ds)
    out.update({
        "heldout_acc": acc["acc"],
        "heldout_base_rate": acc["base_rate"],
        "iwae100_loglik_per_cell": iwae["loglik_per_cell"],
        "iwae_s": iwae_s,
        "impute_s": impute_s,
        "new_person_acc": new_person["acc"],
        "new_person_persons_per_sec": new_person["persons_per_sec"],
        # beside the reference's keys
        "device": card(dev),
        "iwae_samples": iwae_samples,
        "num_samples": num_samples,
        "hidden_dim": hidden_dim,
        "chunk": chunk,
        "chunk_elbos": chunk_elbos,
        "ms_per_epoch_host": per_step_host * 1e3,
        "first_chunk_s": first_chunk_s,
        "one_chunk_s": t_one_chunk,
        "csv_write_s": host["csv_write_s"],
        "new_person_base_rate": new_person["base_rate"],
        "new_person_warm_persons_per_sec":
            new_person["warm_persons_per_sec"],
        "peak_eval_hbm_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                             if dev.type == "cuda" else None),
    })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", default=None,
                    help="the CSV (written if absent; default under build/, "
                         "named by rows, users, lexemes and seed)")
    ap.add_argument("--rows", type=int, default=13_000_000)
    ap.add_argument("--users", type=int, default=140_000)
    ap.add_argument("--lexemes", type=int, default=2048)
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--chunk", type=int, default=100,
                    help="full-batch epochs fused per CUDA graph replay")
    ap.add_argument("--hidden-dim", type=int, default=256)
    ap.add_argument("--num-samples", type=int, default=5)
    ap.add_argument("--new-person-frac", type=float, default=0.03)
    ap.add_argument("--iwae-samples", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    out = run(args.csv, args.rows, args.users, args.lexemes, args.epochs,
              args.chunk, args.hidden_dim, args.num_samples,
              args.new_person_frac, args.iwae_samples, args.seed,
              device="cpu" if args.cpu else None)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
