"""Hold-out masking, the Dataset container, splits and person minibatches
(numpy copy of `vibo_tpu.data.masking`: `Dataset`, `holdout_split`,
`split_persons`, `split_items`, `pad_to_multiple` and `batch_iterator`; the
same seed gives byte-identical arrays).

Protocol (arXiv:2002.00276 section 6.3): hide a fraction of the OBSERVED
cells; train on the rest; the hidden cells are the imputation test set.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(eq=False)
class Dataset:
    """Dense response data with train/held-out masks.

    response:     (N, M) float32 {0, 1} (grm/gpcm: categories
                  {0..num_categories-1}); zero where unobserved.
    train_mask:   (N, M) float32; observed cells used for training.
    heldout_mask: (N, M) float32; observed cells hidden for imputation eval,
                  disjoint from train_mask.
    """
    response: np.ndarray
    train_mask: np.ndarray
    heldout_mask: np.ndarray
    name: str = "dataset"
    num_persons: int | None = None
    num_items: int | None = None
    person_ids: list | None = None
    item_ids: list | None = None
    num_categories: int = 2

    def __post_init__(self):
        if self.num_persons is None:
            self.num_persons = self.response.shape[0]
        if self.num_items is None:
            self.num_items = self.response.shape[1]

    @property
    def shape(self):
        return self.response.shape


def holdout_split(response: np.ndarray, mask: np.ndarray,
                  holdout_frac: float = 0.1, seed: int = 0,
                  name: str = "dataset", person_ids: list | None = None,
                  item_ids: list | None = None,
                  num_categories: int = 2) -> Dataset:
    """Hide `holdout_frac` of the observed cells uniformly at random.

    Draws in row blocks from one generator: `Generator.random` fills its
    output sequentially from the bit stream, so the blocked draw gives the
    same hide pattern as one (N, M) draw with ~3 row blocks of scratch."""
    rng = np.random.default_rng(seed + 101)
    n, m = mask.shape
    heldout_mask = np.empty((n, m), np.float32)
    train_mask = np.empty((n, m), np.float32)
    block = max(1, min(n, (1 << 24) // max(1, m)))
    rbuf = np.empty((block, m), np.float64)
    observed = np.empty((block, m), bool)
    hide = np.empty((block, m), bool)
    for s in range(0, n, block):
        e = min(n, s + block)
        b = e - s
        rng.random(out=rbuf[:b])
        np.greater(mask[s:e], 0, out=observed[:b])
        np.less(rbuf[:b], holdout_frac, out=hide[:b])
        hide[:b] &= observed[:b]
        np.copyto(heldout_mask[s:e], hide[:b], casting="unsafe")
        np.logical_not(hide[:b], out=hide[:b])
        observed[:b] &= hide[:b]
        np.copyto(train_mask[s:e], observed[:b], casting="unsafe")
    return Dataset(response=np.asarray(response, np.float32),
                   train_mask=train_mask, heldout_mask=heldout_mask, name=name,
                   person_ids=person_ids, item_ids=item_ids,
                   num_categories=num_categories)


def split_persons(ds: Dataset, test_frac: float = 0.1, seed: int = 0
                  ) -> tuple[Dataset, Dataset]:
    """Split persons into train/test groups (amortized inference on new
    students, arXiv:2002.00276 section 6): a permutation from
    default_rng(seed + 202), its first round(N * test_frac) (at least one)
    persons the test group, both groups in row order."""
    rng = np.random.default_rng(seed + 202)
    n = ds.response.shape[0]
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * test_frac)))
    test_idx, train_idx = np.sort(perm[:n_test]), np.sort(perm[n_test:])

    def take(idx, tag):
        pids = ([ds.person_ids[k] for k in idx]
                if ds.person_ids is not None else None)
        return Dataset(response=ds.response[idx],
                       train_mask=ds.train_mask[idx],
                       heldout_mask=ds.heldout_mask[idx],
                       name=f"{ds.name}/{tag}", person_ids=pids,
                       item_ids=ds.item_ids, num_categories=ds.num_categories)
    return take(train_idx, "train"), take(test_idx, "test")


def split_items(ds: Dataset, test_frac: float = 0.1, seed: int = 0
                ) -> tuple[Dataset, Dataset]:
    """Split ITEMS into train/test column groups (cold-start items), a
    permutation from default_rng(seed + 808) as split_persons does for
    rows. Scoring unseen items needs the amortized item posterior
    (ROADMAP's "Posterior and conditioning families")."""
    rng = np.random.default_rng(seed + 808)
    m = ds.response.shape[1]
    perm = rng.permutation(m)
    m_test = max(1, int(round(m * test_frac)))
    test_idx, train_idx = np.sort(perm[:m_test]), np.sort(perm[m_test:])

    def take(idx, tag):
        iids = ([ds.item_ids[k] for k in idx]
                if ds.item_ids is not None else None)
        return Dataset(response=ds.response[:, idx],
                       train_mask=ds.train_mask[:, idx],
                       heldout_mask=ds.heldout_mask[:, idx],
                       name=f"{ds.name}/{tag}", person_ids=ds.person_ids,
                       item_ids=iids, num_categories=ds.num_categories)
    return take(train_idx, "train-items"), take(test_idx, "test-items")


def pad_to_multiple(ds: Dataset, person_multiple: int = 8,
                    item_multiple: int = 128) -> Dataset:
    """Zero-pad persons/items up to the given multiples. Padded cells have
    mask 0 everywhere, so objectives and metrics are unchanged exactly;
    num_persons/num_items keep the true sizes."""
    n, m = ds.response.shape
    np_pad = (-n) % person_multiple
    mi_pad = (-m) % item_multiple
    if np_pad == 0 and mi_pad == 0:
        return ds
    pad = ((0, np_pad), (0, mi_pad))
    return Dataset(
        response=np.pad(ds.response, pad),
        train_mask=np.pad(ds.train_mask, pad),
        heldout_mask=np.pad(ds.heldout_mask, pad), name=ds.name,
        num_persons=n, num_items=m, person_ids=ds.person_ids,
        item_ids=ds.item_ids, num_categories=ds.num_categories)


def batch_iterator(ds: Dataset, batch_size: int, seed: int, epoch: int):
    """Yield (response, train_mask) person minibatches, reshuffled per epoch
    by a permutation from default_rng((seed * 100003 + epoch) & 0x7FFFFFFF).

    The last partial batch is zero-padded (mask 0 rows) so every step has
    the same shape; the objectives treat such rows as inert."""
    n = ds.response.shape[0]
    rng = np.random.default_rng((seed * 100003 + epoch) & 0x7FFFFFFF)
    perm = rng.permutation(n)
    for start in range(0, n, batch_size):
        idx = perm[start:start + batch_size]
        resp = ds.response[idx]
        mask = ds.train_mask[idx]
        if idx.shape[0] < batch_size:
            pad = batch_size - idx.shape[0]
            resp = np.concatenate([resp, np.zeros((pad, resp.shape[1]),
                                                  resp.dtype)])
            mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]),
                                                  mask.dtype)])
        yield resp, mask
