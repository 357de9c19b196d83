"""VIBO model and its networks, and the HMC and MLE/MAP baselines
(counterpart of `vibo_tpu.models`)."""

from vibo_tpu_torch.models import hmc, mle
from vibo_tpu_torch.models.vibo import VIBO, VIBOConfig

__all__ = ["VIBO", "VIBOConfig", "hmc", "mle"]
