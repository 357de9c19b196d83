"""Build and bind the hand-written CUDA kernels under `vibo_tpu_torch/csrc/`.

Each `csrc/*.cu` file has a plain C interface (pointers, sizes, strides and a
`cudaStream_t`, returning `cudaGetLastError()`), is compiled by `nvcc` for
`sm_90a` into its own shared library and loaded with `ctypes`. Libraries go to
`build/vibo_tpu_torch/` beside the package, named by a hash of the source, the
headers it may include (`csrc/*.cuh`) and the flags, so a changed source or
header rebuilds and an unchanged one is reused. All
missing libraries are compiled at once, one `nvcc` process per source.

Nothing here runs at import time: the CPU tests import every module without
`nvcc`, and a build starts only at the first launch on a CUDA tensor (or
through `build()`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "vibo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the CUDA kernels cannot be built on this machine")


def lib_path(source: str) -> Path:
    """Library path for csrc/<source>, keyed by a hash of the source, the
    shared headers (csrc/*.cuh) and the flags."""
    src = CSRC_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def all_sources() -> list[str]:
    return sorted(p.name for p in CSRC_DIR.glob("*.cu"))


def build(sources=None) -> dict:
    """Compile every source in `sources` (default: all of csrc/) whose
    library is missing, all nvcc processes started together. Returns
    {source: {"seconds": wall time of its build or 0.0 if cached,
    "log": path of the nvcc/ptxas output}}. Raises on any failure."""
    sources = all_sources() if sources is None else list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for s in sources:
        lib = lib_path(s)
        log = lib.with_suffix(".log")
        out[s] = {"seconds": 0.0, "log": str(log)}
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, lib, log, time.perf_counter())
    failed = []
    for s, (proc, tmp, lib, log, t0) in procs.items():
        text, _ = proc.communicate()
        out[s]["seconds"] = time.perf_counter() - t0
        log.write_text(text)
        if proc.returncode != 0:
            failed.append(f"{s} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def bind(source: str, symbol: str, argtypes: list):
    """(function, library): the C function `symbol` of csrc/<source>'s
    library (built first if missing) returning a cudaError_t as int, and the
    library, whose vibo_error_string names such a code."""
    lib_file = lib_path(source)
    if not lib_file.exists():
        build([source])
    lib = ctypes.CDLL(str(lib_file))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = lib.vibo_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, lib


def check(rc: int, lib, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.vibo_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError {rc})")


class Kernel:
    """One C entry point of a csrc/ library with a launch counter.

    `launches` counts successful launches through __call__ only; the
    wrapper calls it where it launches the kernel and nowhere else. A call
    on a stream that a CUDA graph is capturing records the launch in the
    graph and is not counted: the graph's replays launch it. Inside
    `recording_captures()` such a call is noted in the recorder instead,
    and the graph's owner adds the noted launches at each replay
    (`add_launches`); elsewhere (the fused trainer's graphs) a profiler
    window sees the replays, not this count.
    `launches_by` splits the count by the `variant` the wrapper names (the
    input reader of a kernel templated on it), or is empty."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name, self.source, self.symbol = name, source, symbol
        self.argtypes = argtypes
        self.launches = 0
        self.launches_by: dict[str, int] = {}
        self._fn = None
        self._lib = None

    def _bind(self):
        if self._fn is None:
            self._fn, self._lib = bind(self.source, self.symbol,
                                       self.argtypes)
        return self._fn

    def __call__(self, *args, variant: str | None = None) -> None:
        rc = self._bind()(*args)
        check(rc, self._lib, f"CUDA kernel {self.name} launch")
        if torch.cuda.is_current_stream_capturing():
            if _RECORDERS:
                key = (self.name, variant)
                _RECORDERS[-1][key] = _RECORDERS[-1].get(key, 0) + 1
            return
        self._count(1, variant)

    def _count(self, n: int, variant: str | None) -> None:
        self.launches += n
        if variant is not None:
            self.launches_by[variant] = self.launches_by.get(variant, 0) + n


KERNELS: dict[str, Kernel] = {}
# the launches noted while a CUDA graph is captured, innermost last
_RECORDERS: list[dict] = []


@contextlib.contextmanager
def recording_captures():
    """Note the kernel launches captured inside the block: yields a dict
    {(kernel name, variant): launches} for add_launches."""
    rec: dict = {}
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.pop()


def add_launches(rec: dict) -> None:
    """Count the launches a recorder noted once more: a graph's replay."""
    for (name, variant), n in rec.items():
        KERNELS[name]._count(n, variant)


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by = {}


P, I = ctypes.c_void_p, ctypes.c_int
