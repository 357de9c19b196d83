"""VIBO model and its networks (counterpart of `vibo_tpu.models`)."""

from vibo_tpu_torch.models.vibo import VIBO, VIBOConfig

__all__ = ["VIBO", "VIBOConfig"]
