from vibo_tpu_torch.data.masking import Dataset, holdout_split
from vibo_tpu_torch.data.synthetic import SyntheticIRT, simulate_irt

__all__ = ["Dataset", "holdout_split", "SyntheticIRT", "simulate_irt"]
