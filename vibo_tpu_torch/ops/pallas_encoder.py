"""Fused packed-input first layer of the ability encoder.

Counterpart of `vibo_tpu.ops.pallas_encoder` (same module name): the first
layer reads the int8 response code (0 = missing, 1 = wrong, 2 = right) and
computes both views' products without materializing the decoded matrices:

  forward:  h (B, H) f32      = rm @ W_r + m @ W_m
  backward: dW_r (M, H) f32   = rm^T @ dh,  dW_m (M, H) f32 = m^T @ dh
  (the code is data: it has no gradient)

Operands are rounded to the compute dtype (bf16 on the flagship) and
accumulated in f32, dh included, as in the Pallas kernel. On a CUDA tensor
the hand-written kernels of csrc/first_layer.cu run (bf16 only); on a CPU
tensor the plain PyTorch versions below run. Nothing else falls back.
"""

from __future__ import annotations

import torch

from vibo_tpu_torch._device import as_dtype, cast_through
from vibo_tpu_torch.ops import _build
from vibo_tpu_torch.ops._build import I, P
from vibo_tpu_torch.ops.packing import decode_packed, packed_row_valid

__all__ = ["packed_first_layer", "first_layer_plain", "first_layer_bwd_plain",
           "packed_row_valid", "FWD", "BWD"]

FWD = _build.register(_build.Kernel(
    "first_layer_fwd", "first_layer.cu", "first_layer_fwd",
    [P, P, P, P, I, I, I, P]))
BWD = _build.register(_build.Kernel(
    "first_layer_bwd", "first_layer.cu", "first_layer_bwd",
    [P, P, P, P, P, I, I, I, I, I, P]))

_TILE, _TK = 64, 32          # csrc/first_layer.cu: output tile, chunk depth
_MIN_SPLIT_ROWS = 256        # students per split, at least


def first_layer_plain(packed, w_r, w_m, compute_dtype=torch.bfloat16):
    """Plain version of the forward kernel: decode, round, f32 matmuls."""
    cd = as_dtype(compute_dtype)
    m, rm = decode_packed(packed)
    return rm @ cast_through(w_r, cd) + m @ cast_through(w_m, cd)


def first_layer_bwd_plain(packed, dh, compute_dtype=torch.bfloat16):
    """Plain version of the backward kernel -> (dW_r, dW_m)."""
    cd = as_dtype(compute_dtype)
    m, rm = decode_packed(packed)
    dh_c = cast_through(dh, cd)
    return rm.T @ dh_c, m.T @ dh_c


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def first_layer_fwd_cuda(packed, w_r, w_m):
    """Launch csrc/first_layer.cu:first_layer_fwd (bf16 operands)."""
    bsz, m = packed.shape
    h = w_r.shape[1]
    out = torch.empty((bsz, h), dtype=torch.float32, device=packed.device)
    FWD(packed.data_ptr(), w_r.data_ptr(), w_m.data_ptr(), out.data_ptr(),
        bsz, m, h, _stream(packed))
    return out


def bwd_splits(bsz: int, m: int, h: int, sm_count: int) -> tuple[int, int]:
    """(splits, rows_per_split) of the backward's student loop: enough
    blocks for about four per SM, at least _MIN_SPLIT_ROWS students each,
    rows_per_split a multiple of the kernel's chunk depth."""
    tiles = -(-m // _TILE) * -(-h // _TILE)
    splits = max(1, min(-(-4 * sm_count // tiles),
                        -(-bsz // _MIN_SPLIT_ROWS)))
    rows = -(-max(bsz, 1) // splits)
    rows = -(-rows // _TK) * _TK
    return -(-max(bsz, 1) // rows), rows


def first_layer_bwd_cuda(packed, dh):
    """Launch csrc/first_layer.cu:first_layer_bwd -> (dW_r, dW_m)."""
    bsz, m = packed.shape
    h = dh.shape[1]
    dev = packed.device
    dwr = torch.empty((m, h), dtype=torch.float32, device=dev)
    dwm = torch.empty((m, h), dtype=torch.float32, device=dev)
    splits, rows = bwd_splits(
        bsz, m, h, torch.cuda.get_device_properties(dev).multi_processor_count)
    part = (torch.empty((splits, 2, m, h), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    BWD(packed.data_ptr(), dh.data_ptr(), dwr.data_ptr(), dwm.data_ptr(),
        None if part is None else part.data_ptr(), bsz, m, h, splits, rows,
        _stream(packed))
    return dwr, dwm


class _FirstLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, w_r, w_m, cd):
        ctx.save_for_backward(packed)
        ctx.cd = cd
        if packed.is_cuda:
            return first_layer_fwd_cuda(packed, w_r, w_m)
        return first_layer_plain(packed, w_r, w_m, cd)

    @staticmethod
    def backward(ctx, dh):
        (packed,) = ctx.saved_tensors
        dh = dh.float().contiguous()
        if packed.is_cuda:
            dwr, dwm = first_layer_bwd_cuda(packed, dh)
        else:
            dwr, dwm = first_layer_bwd_plain(packed, dh, ctx.cd)
        return None, dwr, dwm, None


def packed_first_layer(packed: torch.Tensor, w_r: torch.Tensor,
                       w_m: torch.Tensor, compute_dtype="bfloat16"):
    """h (B, H) f32 = (r*m) @ w_r + m @ w_m, decoded on the fly from the
    int8 code. Differentiable with respect to w_r and w_m."""
    cd = as_dtype(compute_dtype)
    if packed.dtype != torch.int8:
        raise ValueError(f"packed must be int8, got {packed.dtype}")
    if packed.ndim != 2 or w_r.shape != w_m.shape or w_r.ndim != 2 \
            or w_r.shape[0] != packed.shape[1]:
        raise ValueError(f"shapes packed {tuple(packed.shape)}, w_r "
                         f"{tuple(w_r.shape)}, w_m {tuple(w_m.shape)} do not "
                         "match (B, M), (M, H), (M, H)")
    devices = {t.device for t in (packed, w_r, w_m)}
    if len(devices) != 1:
        raise ValueError(f"packed, w_r and w_m lie on different devices: "
                         f"{sorted(map(str, devices))}")
    w_r, w_m = w_r.float(), w_m.float()
    if packed.is_cuda:
        if cd != torch.bfloat16:
            raise NotImplementedError(
                "the CUDA first-layer kernel runs bf16 operands only; the "
                "f32 variant is ROADMAP queue A item 3")
        packed, w_r, w_m = (packed.contiguous(), w_r.contiguous(),
                            w_m.contiguous())
    elif packed.device.type != "cpu":
        raise ValueError(f"no kernel for device {packed.device}")
    return _FirstLayer.apply(packed, w_r, w_m, cd)
