"""VIBO model and its networks, and the HMC, MLE/MAP and EM baselines
(counterpart of `vibo_tpu.models`)."""

from vibo_tpu_torch.models import em, hmc, mle
from vibo_tpu_torch.models.vibo import VIBO, VIBOConfig

__all__ = ["VIBO", "VIBOConfig", "em", "hmc", "mle"]
