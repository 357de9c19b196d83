"""Meters, wall-clock timers and JSONL metrics (counterpart of
`vibo_tpu.utils.metrics`): an AverageMeter, a Timer whose `sync` waits for
the card's queued work (torch.cuda.synchronize on a CUDA tensor; a CPU
tensor is ready when it exists), and a logger writing one JSON record an
event (step, elbo, kl terms, held-out accuracy, cells/s).
"""

from __future__ import annotations

import json
import time

import torch


class AverageMeter:
    """A running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Timer:
    """Context manager timing a block; pass outputs through `sync` so the
    device work they depend on is inside the time."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False

    @staticmethod
    def sync(x):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
        return x


class MetricsLogger:
    """Append-only JSONL metrics; also echoes a short line to stdout."""

    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, **record):
        record.setdefault("time", time.time())
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            short = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in record.items() if k != "time"}
            print(" ".join(f"{k}={v}" for k, v in short.items()), flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
