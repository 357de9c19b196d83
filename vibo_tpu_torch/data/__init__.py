from vibo_tpu_torch.data.masking import Dataset, batch_iterator, holdout_split
from vibo_tpu_torch.data.synthetic import SyntheticIRT, simulate_irt

__all__ = ["Dataset", "batch_iterator", "holdout_split", "SyntheticIRT",
           "simulate_irt"]
