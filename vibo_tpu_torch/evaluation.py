"""Held-out imputation accuracy (counterpart of
`vibo_tpu.evaluation.imputation_accuracy`).

Protocol (arXiv:2002.00276 section 6.3): encode each person's train-visible
responses, push the posterior-mean ability and the item-posterior means
through the link, predict p > 0.5 on the hidden cells.
"""

from __future__ import annotations

import numpy as np
import torch

from vibo_tpu_torch.data.masking import Dataset
from vibo_tpu_torch.models.vibo import VIBO


@torch.no_grad()
def imputation_accuracy(model: VIBO, params, ds: Dataset,
                        block_size: int = 16384,
                        item_mean: dict | None = None) -> dict:
    """{"acc", "base_rate" (majority-class accuracy), "num_heldout"} over
    ds.heldout_mask, in person blocks of block_size on the model's device.
    item_mean: optional precomputed item means (default: the posterior's)."""
    if item_mean is None:
        item_mean = model.item_posterior_mean(params)
    dev = model.device
    correct, total = 0.0, 0.0
    counts = np.zeros(2)
    for s in range(0, ds.response.shape[0], block_size):
        e = min(s + block_size, ds.response.shape[0])
        resp, tmask, hmask = (torch.from_numpy(np.ascontiguousarray(x[s:e],
                                                                    np.float32)
                                               ).to(dev)
                              for x in (ds.response, ds.train_mask,
                                        ds.heldout_mask))
        prob = model.impute_prob_with_items(params, resp, tmask, item_mean)
        pred = (prob > 0.5).float()
        correct += float((hmask * (pred == resp)).sum())
        total += float(hmask.sum())
        counts += [float((hmask * (resp == c)).sum()) for c in (0, 1)]
    return {"acc": correct / max(total, 1.0),
            "base_rate": float(counts.max()) / max(total, 1.0),
            "num_heldout": int(total)}
