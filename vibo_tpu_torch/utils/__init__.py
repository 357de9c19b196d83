"""Utilities (counterpart of `vibo_tpu.utils`): meters, timers, the JSONL
metrics logger, host-memory advice and the profiler."""

from vibo_tpu_torch.utils.metrics import AverageMeter, MetricsLogger, Timer

__all__ = ["AverageMeter", "MetricsLogger", "Timer"]
