"""The port's data layer against the JAX package's: the splits and the
padding, long_to_matrix, every offline surrogate of load_dataset (Gradescope
also graded at C = 5), and the CSV path of each dataset through the native
parser and through the Python path — all byte-equal. The native library's
errors (a missing column, a malformed number) and lines longer than any
fixed buffer; the surrogates the same under two hash seeds."""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.data import loaders as jloaders, masking as jmasking
from vibo_tpu.data import native as jnative
from vibo_tpu_torch.data import loaders, masking, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("response", "train_mask", "heldout_mask")


def _same_dataset(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("name", "num_persons", "num_items", "person_ids", "item_ids",
              "num_categories"):
        assert getattr(got, f) == getattr(want, f), f


def _jax_ds(n=60, m=20, c=2):
    sim = jsim("grm" if c > 2 else "2pl", n, m, seed=3, missing_rate=0.2,
               num_categories=max(c, 3))
    ds = jholdout(sim.response, sim.mask, 0.2, seed=1, name="toy",
                  person_ids=[f"p{i}" for i in range(n)],
                  item_ids=[f"i{j}" for j in range(m)],
                  num_categories=sim.num_categories if c > 2 else 2)
    return ds


def _as_port(ds):
    return masking.Dataset(response=ds.response, train_mask=ds.train_mask,
                           heldout_mask=ds.heldout_mask, name=ds.name,
                           person_ids=ds.person_ids, item_ids=ds.item_ids,
                           num_categories=ds.num_categories)


@pytest.mark.parametrize("c", [2, 5])
@pytest.mark.parametrize("seed,frac", [(0, 0.1), (7, 0.35)])
def test_splits_and_padding_match_jax(c, seed, frac):
    jds = _jax_ds(c=c)
    ds = _as_port(jds)
    for jsplit, split in ((jmasking.split_persons, masking.split_persons),
                          (jmasking.split_items, masking.split_items)):
        for got, want in zip(split(ds, frac, seed), jsplit(jds, frac, seed)):
            _same_dataset(got, want)
    for mult in ((8, 128), (7, 3), (1, 1)):
        _same_dataset(masking.pad_to_multiple(ds, *mult),
                      jmasking.pad_to_multiple(jds, *mult))


@pytest.mark.parametrize("categories", [None, 4])
def test_long_to_matrix_matches_jax(categories):
    rng = np.random.default_rng(2)
    rows = [(f"p{p}", f"i{i}", float(rng.integers(0, 5)) / 2.0)
            for p in range(30) for i in range(12) if rng.random() < 0.7]
    rows += [("p0", "i0", 3.0), ("p0", "i0", 0.0),     # last one wins
             ("rare", "i1", 1.0), ("p1", "rare_item", 1.0)]
    for min_p, min_i in ((5, 5), (1, 1)):
        got = loaders.long_to_matrix(rows, min_p, min_i, return_ids=True,
                                     categories=categories)
        want = jloaders.long_to_matrix(rows, min_p, min_i, return_ids=True,
                                       categories=categories)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert got[2:] == want[2:]


@pytest.mark.parametrize("name,kw", [
    ("pisa", {}), ("wordbank", {}), ("critlangacq", {}),
    ("gradescope", {}), ("gradescope", {"num_categories": 5}),
    ("duolingo", {"seed": 1, "holdout_frac": 0.2})])
def test_surrogates_match_jax(name, kw):
    """duolingo's 20,000 x 2,000 once; the others at their own scale."""
    got = loaders.load_dataset(name, **kw)
    want = jloaders.load_dataset(name, **kw)
    assert got.name == f"{name}-surrogate"
    _same_dataset(got, want)


def test_polytomous_only_for_gradescope():
    for mod in (loaders, jloaders):
        with pytest.raises(ValueError, match="gradescope protocol"):
            mod.load_dataset("pisa", num_categories=4)
        with pytest.raises(ValueError, match="unknown dataset"):
            mod.load_dataset("nope")


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _csv_case(name, rng):
    if name in ("pisa", "critlangacq"):
        header = (("student_id", "item_id", "correct") if name == "pisa"
                  else ("subject_id", "question_id", "correct"))
        rows = [(f"s{p}", f"q{i:02d}", int(rng.random() < 0.55))
                for p in range(25) for i in range(9) if rng.random() < 0.8]
    elif name == "duolingo":
        header = ("user_id", "lexeme_id", "session_correct", "session_seen")
        rows = [(f"u{p}", f"lex{i}", int(c), 3)
                for p in range(25) for i in range(9)
                for c in [rng.integers(0, 4)] if rng.random() < 0.8]
    elif name == "wordbank":
        header = ("child_id", "item_definition", "value")
        vals = ["produces", "understands", "", " Produces "]
        rows = [(f"c{p}", f"w{i}", vals[int(rng.integers(0, 4))])
                for p in range(25) for i in range(9)]
    else:
        header = ("student_id", "question_id", "score", "max_score")
        rows = [(f"s{p}", f"q{i}", float(rng.integers(0, 11)), 10.0)
                for p in range(25) for i in range(9)]
    return header, rows


@pytest.mark.parametrize("name,kw", [
    ("pisa", {}), ("critlangacq", {}), ("duolingo", {}), ("wordbank", {}),
    ("gradescope", {}), ("gradescope", {"num_categories": 5})])
def test_csv_paths_match_jax(name, kw, tmp_path, monkeypatch):
    """Each dataset's CSV through the native parser (where its mode has one)
    and through the Python path, in both packages: four byte-equal
    Datasets."""
    header, rows = _csv_case(name, np.random.default_rng(5))
    _write(tmp_path / f"{name}.csv", header, rows)
    assert native.available() and jnative.available()
    args = dict(data_dir=str(tmp_path), seed=2, **kw)
    got_native = loaders.load_dataset(name, **args)
    want = jloaders.load_dataset(name, **args)
    _same_dataset(got_native, want)
    assert got_native.name == name and got_native.item_ids
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    _same_dataset(loaders.load_dataset(name, **args), want)
    _same_dataset(jloaders.load_dataset(name, **args), want)


def test_native_library_is_built_beside_the_package():
    lib = native.lib_path()
    assert native.available() and lib.exists()
    assert lib.parent == native.BUILD_DIR
    assert "native" not in lib.parent.parts[-2:]


def test_native_errors_and_long_lines(tmp_path):
    bad = tmp_path / "cols.csv"
    _write(bad, ("x", "y", "z"), [("a", "b", 1)])
    with pytest.raises(ValueError, match="missing column"):
        native.parse_long_csv(str(bad), "student_id", "item_id", "correct")
    bad = tmp_path / "num.csv"
    _write(bad, ("student_id", "item_id", "correct"),
           [("p0", "i0", 1), ("p0", "i1", "oops"), ("p1", "i0", 0)])
    with pytest.raises(ValueError, match="unparseable"):
        native.parse_long_csv(str(bad), "student_id", "item_id", "correct",
                              min_per_person=1, min_per_item=1)
    rng = np.random.default_rng(0)
    long_id = "p" + "x" * 100_000          # one ~100 KB field
    rows = [(long_id, f"i{i}", int(rng.random() < 0.5)) for i in range(12)]
    rows += [(f"q{p}", f"i{i}", 1) for p in range(8) for i in range(12)]
    path = tmp_path / "long.csv"
    _write(path, ("student_id", "item_id", "correct"), rows)
    got = native.parse_long_csv(str(path), "student_id", "item_id", "correct")
    want = jnative.parse_long_csv(str(path), "student_id", "item_id",
                                  "correct")
    for a, b in zip(got[:2], want[:2]):
        assert a.tobytes() == b.tobytes()
    assert got[2:] == want[2:]
    assert long_id in got[2] and len(got[2]) == 9


def test_surrogates_identical_across_hash_seeds():
    code = ("import hashlib, sys; sys.path.insert(0, {repo!r}); "
            "from vibo_tpu_torch.data import load_dataset; "
            "ds = load_dataset('gradescope', num_categories=4); "
            "ds2 = load_dataset('critlangacq'); "
            "print(hashlib.sha256(ds.response.tobytes() + "
            "ds.train_mask.tobytes() + ds2.response.tobytes()).hexdigest())"
            ).format(repo=REPO)
    digests = set()
    for hs in ("1", "987"):
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env={**os.environ, "PYTHONHASHSEED": hs},
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        digests.add(out.stdout.strip())
    assert len(digests) == 1
