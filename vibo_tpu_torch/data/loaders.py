"""Real-dataset loaders: PISA 2015 Science, DuoLingo, WordBank, CritLangAcq,
Gradescope (copy of `vibo_tpu.data.loaders`; the same files and seeds give
byte-identical Datasets).

Each dataset reduces to a dense person x item binary matrix and an
observation mask after per-person/per-item minimum-response filtering
(`long_to_matrix`); each contributes a column-mapping adapter. A loader
reads `<data_dir>/<name>.csv` when it exists, else builds a seeded synthetic
surrogate at the dataset's documented scale (the Dataset's name then ends in
`-surrogate`), so every dataset runs offline.

File formats accepted:
- PISA 2015 science:  student_id, item_id, correct.
- DuoLingo:           user_id, lexeme_id, session_correct, session_seen —
  binarized to all-correct-in-session.
- WordBank:           child_id, item_definition, value ("produces" /
  "understands" / "") — binarized to produces.
- CritLangAcq:        subject_id, question_id, correct.
- Gradescope:         student_id, question_id, score, max_score — binarized
  at score == max_score, or kept polytomous (num_categories=C > 2): the
  partial credit score/max_score quantized to the nearest of C ordinal
  levels for the graded response model (arXiv:2108.11579).
"""

from __future__ import annotations

import csv
import os
import zlib
from collections import Counter

import numpy as np

from vibo_tpu_torch.data import native
from vibo_tpu_torch.data.masking import Dataset, holdout_split
from vibo_tpu_torch.data.synthetic import simulate_irt

# Documented approximate scales (arXiv:2002.00276 Table 1) of the offline
# surrogates: (persons, items, observed density, generative irt model,
# generative ability dim). PISA is multidimensional (K = 2), WordBank has
# nonlinear response curves over K = 2 (the deep link's showcase),
# Gradescope a guessing floor (3PL), CritLangAcq is Rasch (1PL), DuoLingo
# 2PL K = 1.
_SURROGATE_SCALES = {
    "pisa":        (5000, 183, 0.45, "2pl", 2),
    "duolingo":    (20000, 2000, 0.02, "2pl", 1),
    "wordbank":    (5520, 680, 1.0, "nonlinear", 2),
    "critlangacq": (6700, 95, 1.0, "1pl", 1),
    "gradescope":  (1254, 3, 1.0, "3pl", 1),
}

# Column-name adapters: raw csv -> (person, item, correct).
_COLUMN_MAPS = {
    "pisa":        ("student_id", "item_id", "correct"),
    "critlangacq": ("subject_id", "question_id", "correct"),
}


def long_to_matrix(rows, min_per_person: int = 5, min_per_item: int = 5,
                   return_ids: bool = False, categories: int | None = None):
    """(person, item, correct) triples -> dense response + observation mask.

    Persons and items with fewer than the minimum observed responses are
    dropped (one pass, as in standard IRT preprocessing); a duplicate
    (person, item) pair keeps its last response. return_ids=True also
    returns the sorted person/item id vocabularies (the rows' and columns'
    order). categories=C keeps the value as an ordinal category (rounded,
    clipped to {0..C-1}) instead of binarizing at 0.5."""
    by_pair: dict[tuple[str, str], float] = {}
    for p, i, c in rows:
        by_pair[(str(p), str(i))] = float(c)
    pc, ic = Counter(), Counter()
    for (p, i) in by_pair:
        pc[p] += 1
        ic[i] += 1
    persons = sorted(p for p, n in pc.items() if n >= min_per_person)
    items = sorted(i for i, n in ic.items() if n >= min_per_item)
    pidx = {p: k for k, p in enumerate(persons)}
    iidx = {i: k for k, i in enumerate(items)}
    resp = np.zeros((len(persons), len(items)), dtype=np.float32)
    mask = np.zeros_like(resp)
    for (p, i), c in by_pair.items():
        if p in pidx and i in iidx:
            if categories is None:
                resp[pidx[p], iidx[i]] = 1.0 if c > 0.5 else 0.0
            else:
                resp[pidx[p], iidx[i]] = min(max(round(c), 0), categories - 1)
            mask[pidx[p], iidx[i]] = 1.0
    if return_ids:
        return resp * mask, mask, persons, items
    return resp * mask, mask


def _read_csv(path):
    with open(path, newline="") as f:
        yield from csv.DictReader(f)


def _load_generic_csv(path, person_col, item_col, correct_col, binarize=None,
                      min_per_person: int = 5, min_per_item: int = 5,
                      native_spec: dict | None = None,
                      categories: int | None = None):
    """The native parser where it is built and the dataset's binarization
    has a native mode (native_spec; binarize=None is the default > 0.5),
    else the Python csv path; both give the same matrices."""
    if categories is None and native.available() \
            and (binarize is None or native_spec is not None):
        return native.parse_long_csv(
            path, person_col, item_col, correct_col,
            min_per_person=min_per_person, min_per_item=min_per_item,
            **(native_spec or {}))
    rows = []
    for row in _read_csv(path):
        c = binarize(row) if binarize else float(row[correct_col])
        rows.append((row[person_col], row[item_col], c))
    return long_to_matrix(rows, min_per_person=min_per_person,
                          min_per_item=min_per_item, return_ids=True,
                          categories=categories)


def _surrogate(name: str, seed: int, num_categories: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """The dataset's offline surrogate, seeded with seed + crc32(name) %
    9973 (a stable digest, not Python's salted hash(), so every process
    builds the same bytes); num_categories makes it graded (grm)."""
    n, m, density, gen_model, gen_k = _SURROGATE_SCALES[name]
    kw = {}
    if num_categories is not None:
        gen_model = "grm"
        kw["num_categories"] = num_categories
    sim = simulate_irt(gen_model, n, m, ability_dim=gen_k,
                       seed=seed + zlib.crc32(name.encode()) % 9973,
                       missing_rate=1.0 - density, **kw)
    return sim.response, sim.mask


def load_dataset(name: str, data_dir: str | None = None,
                 holdout_frac: float = 0.1, seed: int = 0,
                 min_per_person: int = 5, min_per_item: int = 5,
                 num_categories: int | None = None) -> Dataset:
    """A named real dataset (or its offline surrogate) with its hold-out
    split: pisa, duolingo, wordbank, critlangacq, gradescope.
    num_categories=C (> 2) keeps Gradescope polytomous (partial credit
    quantized to C levels); the other datasets are binary at the source and
    refuse it."""
    name = name.lower()
    if name not in _SURROGATE_SCALES:
        raise ValueError(f"unknown dataset {name!r}; options: "
                         f"{sorted(_SURROGATE_SCALES)}")
    if num_categories is not None and num_categories <= 2:
        num_categories = None
    if num_categories is not None and name != "gradescope":
        raise ValueError(
            f"polytomous loading (num_categories={num_categories}) is a "
            f"gradescope protocol — {name!r} is binary at the source "
            f"(correct/incorrect); only gradescope's partial-credit "
            f"score/max_score supports graded quantization")
    path = None
    if data_dir:
        cand = os.path.join(data_dir, f"{name}.csv")
        if os.path.exists(cand):
            path = cand
    person_ids = item_ids = None
    if path is None:
        resp, mask = _surrogate(name, seed, num_categories)
        tag = f"{name}-surrogate"
    else:
        kw = dict(min_per_person=min_per_person, min_per_item=min_per_item)
        if name in _COLUMN_MAPS:
            pcol, icol, ccol = _COLUMN_MAPS[name]
            resp, mask, person_ids, item_ids = _load_generic_csv(
                path, pcol, icol, ccol, **kw)
        elif name == "duolingo":
            resp, mask, person_ids, item_ids = _load_generic_csv(
                path, "user_id", "lexeme_id", "session_correct",
                binarize=lambda r: 1.0 if float(r["session_correct"]) >=
                float(r.get("session_seen", 1)) else 0.0,
                native_spec=dict(denom_col="session_seen",
                                 mode=native.BINARIZE_GE_DENOM_OPT), **kw)
        elif name == "wordbank":
            resp, mask, person_ids, item_ids = _load_generic_csv(
                path, "child_id", "item_definition", "value",
                binarize=lambda r: 1.0 if r["value"].strip().lower()
                == "produces" else 0.0,
                native_spec=dict(match="produces",
                                 mode=native.BINARIZE_STR_MATCH), **kw)
        elif num_categories is not None:       # gradescope, graded
            c1 = num_categories - 1
            resp, mask, person_ids, item_ids = _load_generic_csv(
                path, "student_id", "question_id", "score",
                binarize=lambda r: round(
                    c1 * min(max(float(r["score"])
                                 / float(r["max_score"]), 0.0), 1.0)),
                categories=num_categories, **kw)
        else:                                  # gradescope, binary
            resp, mask, person_ids, item_ids = _load_generic_csv(
                path, "student_id", "question_id", "score",
                binarize=lambda r: 1.0 if float(r["score"])
                >= float(r["max_score"]) else 0.0,
                native_spec=dict(denom_col="max_score",
                                 mode=native.BINARIZE_GE_DENOM), **kw)
        tag = name
    return holdout_split(resp, mask, holdout_frac=holdout_frac, seed=seed,
                         name=tag, person_ids=person_ids, item_ids=item_ids,
                         num_categories=num_categories or 2)
