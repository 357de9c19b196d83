"""ctypes bindings for the repo's native C++ response-matrix loader
(`native/response_loader.cpp`; the same ABI as `vibo_tpu.data.native`).

The library is built with g++ and the flags of `native/Makefile` into
`build/vibo_tpu_torch/` beside the package, named by a hash of the source
and the flags (as `ops/_build.py` names the CUDA libraries), so a changed
source rebuilds and nothing is written under `native/`. Nothing is built at
import time: the first `available()` or `parse_long_csv` call builds it.

`parse_long_csv(path, person_col, item_col, correct_col, ...)` returns
(response f32, mask f32, person_ids, item_ids) with the semantics of
`data.loaders.long_to_matrix`. Where no library can be built (no g++),
`available()` is False and the loaders take their Python path, as in the
JAX package; this is host-side CSV parsing, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from vibo_tpu_torch.utils.hostmem import zeros_hugepages

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "response_loader.cpp"
BUILD_DIR = REPO_DIR / "build" / "vibo_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

BINARIZE_GT_HALF = 0        # numeric value > 0.5
BINARIZE_GE_DENOM = 1       # numeric value >= required denominator column
BINARIZE_GE_DENOM_OPT = 2   # like 1, denom column optional (defaults to 1)
BINARIZE_STR_MATCH = 3      # trimmed lowercase string equality

_lock = threading.Lock()
_lib = None
_build_failed = False


def lib_path() -> Path:
    """The library's path, keyed by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"response_loader-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)           # atomic: concurrent builds agree
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load_library():
    """The ctypes library, built on first use; None if it cannot be."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or not SOURCE.exists():
            return None
        lib_file = lib_path()
        if not lib_file.exists() and not _build(lib_file):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(lib_file))
        lib.rl_parse.restype = ctypes.c_void_p
        lib.rl_parse.argtypes = [ctypes.c_char_p] * 4 + [ctypes.c_int] * 2
        lib.rl_parse_ex.restype = ctypes.c_void_p
        lib.rl_parse_ex.argtypes = [ctypes.c_char_p] * 6 + [ctypes.c_int] * 3
        lib.rl_parse_errors.restype = ctypes.c_int64
        lib.rl_parse_errors.argtypes = [ctypes.c_void_p]
        lib.rl_num_persons.restype = ctypes.c_int64
        lib.rl_num_persons.argtypes = [ctypes.c_void_p]
        lib.rl_num_items.restype = ctypes.c_int64
        lib.rl_num_items.argtypes = [ctypes.c_void_p]
        lib.rl_error.restype = ctypes.c_char_p
        lib.rl_error.argtypes = [ctypes.c_void_p]
        lib.rl_fill.restype = None
        lib.rl_fill.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int8)]
        lib.rl_fill_f32.restype = None
        lib.rl_fill_f32.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_float)]
        lib.rl_person_ids.restype = ctypes.c_char_p
        lib.rl_person_ids.argtypes = [ctypes.c_void_p]
        lib.rl_item_ids.restype = ctypes.c_char_p
        lib.rl_item_ids.argtypes = [ctypes.c_void_p]
        lib.rl_free.restype = None
        lib.rl_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def parse_long_csv(path: str, person_col: str, item_col: str, correct_col: str,
                   min_per_person: int = 5, min_per_item: int = 5,
                   denom_col: str = "", match: str = "",
                   mode: int = BINARIZE_GT_HALF):
    """Native CSV -> (response, mask, person_ids, item_ids). Raises
    ValueError on a missing column and on rows with an unparseable numeric
    field (as the Python path's float() does)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable (no g++ / build failed)")
    h = lib.rl_parse_ex(path.encode(), person_col.encode(), item_col.encode(),
                        correct_col.encode(), denom_col.encode(),
                        match.encode(), mode, min_per_person, min_per_item)
    try:
        err = lib.rl_error(h)
        if err:
            raise ValueError(f"native loader: {err.decode()}")
        bad = lib.rl_parse_errors(h)
        if bad:
            raise ValueError(
                f"native loader: {bad} unparseable row(s) in {path} "
                "(malformed numeric field or too few columns)")
        n = lib.rl_num_persons(h)
        m = lib.rl_num_items(h)
        # lazily zeroed pages, THP-advised; the C scatter touches only the
        # observed cells
        response = zeros_hugepages((n, m), dtype=np.float32)
        mask = zeros_hugepages((n, m), dtype=np.float32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rl_fill_f32(h, response.ctypes.data_as(f32p),
                        mask.ctypes.data_as(f32p))
        person_ids = lib.rl_person_ids(h).decode().splitlines()
        item_ids = lib.rl_item_ids(h).decode().splitlines()
    finally:
        lib.rl_free(h)
    return response, mask, person_ids, item_ids
