"""Data layer (counterpart of `vibo_tpu.data`): synthetic IRT simulators,
hold-out masking and splits, the real-dataset loaders with their offline
surrogates and the native CSV parser. Host-side numpy."""

from vibo_tpu_torch.data.loaders import load_dataset, long_to_matrix
from vibo_tpu_torch.data.masking import (Dataset, batch_iterator,
                                         holdout_split, pad_to_multiple,
                                         split_items, split_persons)
from vibo_tpu_torch.data.synthetic import SyntheticIRT, simulate_irt

__all__ = ["Dataset", "batch_iterator", "holdout_split", "load_dataset",
           "long_to_matrix", "pad_to_multiple", "split_items",
           "split_persons", "SyntheticIRT", "simulate_irt"]
