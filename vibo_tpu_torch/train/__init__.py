"""Training harness and checkpoints (counterpart of `vibo_tpu.train`)."""

from vibo_tpu_torch.train.checkpoint import (
    load_checkpoint, load_params_self_describing, save_checkpoint,
    train_state, transplant_params)
from vibo_tpu_torch.train.trainer import Trainer, TrainConfig, make_optimizer

__all__ = ["Trainer", "TrainConfig", "load_checkpoint",
           "load_params_self_describing", "make_optimizer",
           "save_checkpoint", "train_state", "transplant_params"]
