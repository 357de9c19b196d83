"""Host-memory helpers: transparent-huge-page-backed numpy allocation (copy
of `vibo_tpu.utils.hostmem`).

First-touch page faults on fresh 4 KiB-paged anonymous memory are slow on
machines whose THP runs in `madvise` mode; `madvise(..., MADV_HUGEPAGE)` on
a fresh allocation before its first write cuts the faults 512x (2 MiB
pages). The data layer's ingestion-scale buffers (dense response and mask
matrices of a GB each) go through `empty_hugepages` / `zeros_hugepages`.

Pure advice on the process's own arrays: on kernels without THP (or off
Linux) madvise fails or does nothing and the arrays behave like plain numpy
allocations. Never required for correctness.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

_MADV_HUGEPAGE = 14
_HUGE = 2 << 20               # 2 MiB THP granule
_MIN_BYTES = 16 << 20         # not worth the syscall below ~16 MB
_libc = None


def _get_libc():
    global _libc
    if _libc is None and sys.platform.startswith("linux"):
        try:
            _libc = ctypes.CDLL("libc.so.6", use_errno=True)
        except OSError:
            _libc = False
    return _libc or None


def madvise_hugepages(a: np.ndarray) -> np.ndarray:
    """Advise THP backing for `a`'s own buffer (best effort, returns `a`).

    Useful only BEFORE the array's pages are first written; numpy's large
    allocations come from a fresh mmap, so call it straight after
    np.empty/np.zeros. Arrays that do not own their buffer are left
    alone."""
    libc = _get_libc()
    if libc is None or a.nbytes < _MIN_BYTES or not a.flags.owndata:
        return a
    addr = a.ctypes.data
    aligned = (addr + _HUGE - 1) & ~(_HUGE - 1)
    length = a.nbytes - (aligned - addr)
    if length >= _HUGE:
        libc.madvise(ctypes.c_void_p(aligned), ctypes.c_size_t(length),
                     _MADV_HUGEPAGE)
    return a


def empty_hugepages(shape, dtype=np.float32) -> np.ndarray:
    return madvise_hugepages(np.empty(shape, dtype))


def zeros_hugepages(shape, dtype=np.float32) -> np.ndarray:
    # np.zeros' pages stay untouched (lazy zero-fill) until written, so the
    # advice still precedes every fault
    return madvise_hugepages(np.zeros(shape, dtype))
