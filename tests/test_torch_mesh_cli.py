"""`train --data-parallel` under torchrun on two gloo CPU ranks
(`python -m torch.distributed.run --nproc_per_node 2 -m vibo_tpu_torch.cli
train ... --cpu --data-parallel`) against the same command in one process,
which trains without a mesh: rank 0 alone prints, and its summary's
numbers match the one-process run's (the final ELBO within 1e-5, the
rounded accuracies, calibration and Pearson correlations equal or within
1e-4); the timings differ."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["train", "synthetic-2pl", "--num-persons", "60", "--num-items",
        "20", "--epochs", "4", "--eval-every", "2", "--hidden-dim", "16",
        "--cpu", "--data-parallel"]
TIMINGS = ("train_seconds", "warm_train_seconds", "cells_per_sec")


def _run(cmd, tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return [line for line in out.stdout.splitlines() if line.startswith("{")]


def test_data_parallel_train_matches_one_process(tmp_path):
    one = _run([sys.executable, "-m", "vibo_tpu_torch.cli", *ARGS], tmp_path)
    two = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", "-m", "vibo_tpu_torch.cli", *ARGS],
               tmp_path)
    assert len(one) == len(two) == 1          # rank 0 prints the summary
    want, got = json.loads(one[0]), json.loads(two[0])
    assert set(got) == set(want)
    for k, v in want.items():
        if k in TIMINGS:
            continue
        if k == "final_elbo":
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
        elif isinstance(v, float):
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)
