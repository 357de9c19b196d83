"""Profiling support (counterpart of `vibo_tpu.utils.prof`):
- `trace(log_dir)`: a torch.profiler window (CPU and, where the card is
  present, CUDA activities) around any region, written into log_dir as a
  Chrome trace (`trace_<pid>.json`; open it in Perfetto or chrome://tracing);
- `device_timer`: a wall-clock bracket whose `force` fetches a result to
  the host, the completion barrier;
- `peak_hbm_bytes`: the card's high-water mark of allocated memory;
- `throughput_report`: (cells, seconds) -> cells/s.

JAX's `enable_compilation_cache` has no counterpart: the port compiles its
kernels once into `build/vibo_tpu_torch/` (ops/_build.py), keyed by their
sources.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region into log_dir/trace_<pid>.json."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def device_timer(result_box: dict, key: str = "seconds"):
    """Times the enclosed block; call result_box['force'](tensor) on the
    block's final device value to put the completion barrier inside it."""
    forced = []

    def force(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()     # the host copy waits for it
        forced.append(True)
        return x

    result_box["force"] = force
    t0 = time.perf_counter()
    try:
        yield result_box
    finally:
        result_box[key] = time.perf_counter() - t0
        result_box["forced"] = bool(forced)


def peak_hbm_bytes(device=None) -> int | None:
    """Peak bytes of device memory allocated by this process on a CUDA
    `device` (None: the current card), torch.cuda.max_memory_allocated;
    None on the CPU, as the JAX package returns None there."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated(device))


def throughput_report(num_cells: int, seconds: float) -> dict:
    return {"response_cells_per_sec": num_cells / max(seconds, 1e-12),
            "cells": num_cells, "seconds": seconds}
