"""Training harness (counterpart of `vibo_tpu.train`)."""

from vibo_tpu_torch.train.trainer import Trainer, TrainConfig, make_optimizer

__all__ = ["Trainer", "TrainConfig", "make_optimizer"]
