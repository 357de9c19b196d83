"""VIBO model and its networks, and the HMC baseline (counterpart of
`vibo_tpu.models`)."""

from vibo_tpu_torch.models import hmc
from vibo_tpu_torch.models.vibo import VIBO, VIBOConfig

__all__ = ["VIBO", "VIBOConfig", "hmc"]
