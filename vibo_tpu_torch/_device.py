"""Device resolution for the PyTorch/CUDA port.

Every entry point takes `device=None`, which means the card ("cuda"). There is
no silent CPU fallback: a machine without CUDA raises, and callers that want
the CPU (the tests) ask for it by name. The CPU runs each kernel's plain
PyTorch version; the card runs the hand-written CUDA kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> cuda; raise if a CUDA device is asked for but absent.

    Also pins float32 matmul and convolution numerics to full f32 (no TF32):
    the JAX reference runs f32 products in full precision, so the port
    states and sets both switches instead of relying on PyTorch's defaults
    (cuDNN allows TF32 by default)."""
    dev = torch.device("cuda" if device is None else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vibo_tpu_torch runs on a CUDA device by default and CUDA is not "
            "available here; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return dev


def same_device(a, b) -> bool:
    """Whether two devices are one: "cuda" without an index is the current
    card, so it equals "cuda:<current>"."""
    def key(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return d.type, torch.cuda.current_device()
        return d.type, d.index
    return key(a) == key(b)


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16", "float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def cast_through(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and carried back as float32 (identity for f32).

    A matmul of two such operands in f32 is exactly JAX's
    dot(x.astype(bf16), w.astype(bf16), preferred_element_type=f32): every
    product of two bf16 values is exact in f32, the sum is f32, and the
    result stays f32 (a bf16 torch.matmul would round its output)."""
    if dtype == torch.float32:
        return x.float()
    return x.to(dtype).float()
