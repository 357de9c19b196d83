"""Raw-ingestion benchmark: the native C++ CSV parser against the Python
path (counterpart of the repo's `scripts/bench_ingest.py`, the same JSON
keys).

Parses a DuoLingo-shaped learning-traces CSV (`gen_duolingo_csv`) through
both ingestion paths of the port's data layer, the C++ reducer
(`data.native.parse_long_csv`, built from `native/response_loader.cpp`) and
the csv.DictReader + `long_to_matrix` Python path (`data.loaders`), checks
that the two matrices are identical, and prints one JSON line with the
host's times. A native library that cannot be built raises: the Python path
is never timed alone.

  python -m vibo_tpu_torch.scripts.bench_ingest build/duo/duolingo.csv
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from vibo_tpu_torch.data import native
from vibo_tpu_torch.data.loaders import _read_csv, long_to_matrix


def require_native() -> None:
    """Raise unless the native CSV parser is built (or can be)."""
    if not native.available():
        raise RuntimeError(
            f"the native CSV parser could not be built from {native.SOURCE} "
            "(g++ missing or failing)")


def run(path: str, skip_python: bool = False) -> dict:
    """Time both paths on `path` -> the JSON line's dict."""
    require_native()
    t0 = time.perf_counter()
    resp_n, mask_n, _, _ = native.parse_long_csv(
        path, "user_id", "lexeme_id", "session_correct",
        denom_col="session_seen", mode=native.BINARIZE_GE_DENOM_OPT)
    t_native = time.perf_counter() - t0
    out = {"rows_file": path,
           "persons": int(resp_n.shape[0]),
           "items": int(resp_n.shape[1]),
           "observed_cells": int(mask_n.sum()),
           "native_s": t_native}
    if skip_python:
        return out

    # load_dataset("duolingo")'s semantics: each (user, lexeme) record
    # binarized to session_correct >= session_seen, the last record wins,
    # then the min-count filter and the dense scatter
    def rows():
        for r in _read_csv(path):
            c = 1.0 if float(r["session_correct"]) >= float(
                r.get("session_seen", 1)) else 0.0
            yield r["user_id"], r["lexeme_id"], c

    t0 = time.perf_counter()
    resp_p, mask_p = long_to_matrix(rows())
    t_python = time.perf_counter() - t0
    out.update(python_s=t_python, speedup=t_python / t_native)
    if resp_p.shape != resp_n.shape:
        raise AssertionError(f"shapes differ: python {resp_p.shape}, "
                             f"native {resp_n.shape}")
    if not np.array_equal(mask_p, mask_n):
        raise AssertionError("mask mismatch native vs python")
    if not np.array_equal(resp_p, resp_n):
        raise AssertionError("response mismatch native vs python")
    out["paths_agree"] = True
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--skip-python", action="store_true",
                    help="only time the native path (Python takes minutes)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.path, args.skip_python)), flush=True)


if __name__ == "__main__":
    main()
