"""Utilities (counterpart of `vibo_tpu.utils`): meters, timers and the
JSONL metrics logger."""

from vibo_tpu_torch.utils.metrics import AverageMeter, MetricsLogger, Timer

__all__ = ["AverageMeter", "MetricsLogger", "Timer"]
