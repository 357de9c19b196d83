"""Fused packed-input first layer of the ability encoder.

Counterpart of `vibo_tpu.ops.pallas_encoder` (same module name): the first
layer reads the int8 response code (0 = missing, 1 = wrong, 2 = right) and
computes both views' products without materializing the decoded matrices:

  forward:  h (B, H) f32      = rm @ W_r + m @ W_m
  backward: dW_r (M, H) f32   = rm^T @ dh,  dW_m (M, H) f32 = m^T @ dh
  (the code is data: it has no gradient)

Operands are rounded to the compute dtype (bf16 on the flagship) and
accumulated in f32, dh included, as in the Pallas kernel. On a CUDA tensor
the hand-written kernels of csrc/first_layer.cu run: bf16 operands, or at
compute_dtype float32 exact f32 products (each f32 operand split into three
bf16 parts, `split_bf16x3`); on a CPU tensor the plain PyTorch versions
below run. Nothing else falls back.
"""

from __future__ import annotations

import torch

from vibo_tpu_torch._device import as_dtype, cast_through
from vibo_tpu_torch.ops import _build
from vibo_tpu_torch.ops._build import I, P
from vibo_tpu_torch.ops.packing import decode_packed, packed_row_valid

__all__ = ["packed_first_layer", "first_layer_plain", "first_layer_bwd_plain",
           "split_bf16x3", "bwd_plan", "packed_row_valid", "FWD", "BWD",
           "FWD_F32", "BWD_F32"]

FWD = _build.register(_build.Kernel(
    "first_layer_fwd", "first_layer.cu", "first_layer_fwd",
    [P, P, P, P, P, I, I, I, I, P]))
BWD = _build.register(_build.Kernel(
    "first_layer_bwd", "first_layer.cu", "first_layer_bwd",
    [P, P, P, P, P, I, I, I, I, I, P]))
FWD_F32 = _build.register(_build.Kernel(
    "first_layer_fwd_f32", "first_layer.cu", "first_layer_fwd_f32",
    [P, P, P, P, P, I, I, I, I, P]))
BWD_F32 = _build.register(_build.Kernel(
    "first_layer_bwd_f32", "first_layer.cu", "first_layer_bwd_f32",
    [P, P, P, P, P, I, I, I, I, I, P]))
# each compute dtype's kernels: (forward, backward, bf16 parts of an operand)
_KERNELS = {torch.bfloat16: (FWD, BWD, 1), torch.float32: (FWD_F32, BWD_F32, 3)}

# csrc/first_layer.cu: contraction chunk, output columns of a tile, items of
# a backward tile, CTAs of the backward's cluster
CHUNK, TILE_N, BWD_TILE_M, CLUSTER = 64, 128, 64, 8


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


def split_bf16x3(w: torch.Tensor):
    """Twin of csrc/first_layer.cu:split_parts<3> -> (hi, mid, lo), three
    f32 tensors whose values are bf16: each part is its remainder with the
    f32's low 16 bits dropped. hi + mid + lo == w exactly for every finite
    w whose lowest set bit is at least 2^-133 (all normal |w| >= 2^-110, and
    0); smaller values lose their bits under 2^-133."""
    def trunc(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)
    w = w.float().contiguous()
    hi = trunc(w)
    r1 = w - hi
    mid = trunc(r1)
    return hi, mid, trunc(r1 - mid)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def code_reader(packed: torch.Tensor) -> str:
    """The code tile reader the kernels take for these rows: "cp16"
    (cp.async of 16 bytes, rows 16-byte aligned), "cp4" (4 bytes) or
    "bytes" (any M)."""
    m, ptr = packed.shape[1], packed.data_ptr()
    if m % 16 == 0 and ptr % 16 == 0:
        return "cp16"
    if m % 4 == 0 and ptr % 4 == 0:
        return "cp4"
    return "bytes"


_READER_CODE = {"cp16": 16, "cp4": 4, "bytes": 1}


def bwd_plan(bsz: int, m: int, h: int) -> dict:
    """The backward's launch: a grid of (item tiles, column tiles, CLUSTER)
    CTAs, each cluster one output tile whose CTA z takes the students
    [z * rows_per_split, (z + 1) * rows_per_split), rows_per_split a
    multiple of the chunk depth, the CLUSTER runs covering B."""
    rows = max(CHUNK, _up(-(-bsz // CLUSTER), CHUNK))
    return {"grid": (-(-m // BWD_TILE_M), -(-h // TILE_N), CLUSTER),
            "rows_per_split": rows}


def first_layer_fwd_cuda(packed, w_r, w_m, compute_dtype=torch.bfloat16):
    """Launch csrc/first_layer.cu's forward in the compute dtype's mode
    (bf16 operands, or exact f32 products from three bf16 parts)."""
    fwd, _, parts = _KERNELS[as_dtype(compute_dtype)]
    bsz, m = packed.shape
    h = w_r.shape[1]
    dev = packed.device
    out = torch.empty((bsz, h), dtype=torch.float32, device=dev)
    wt = torch.empty((parts * _up(h, TILE_N) * 2 * _up(m, CHUNK),),
                     dtype=torch.bfloat16, device=dev)
    reader = code_reader(packed)
    fwd(packed.data_ptr(), w_r.data_ptr(), w_m.data_ptr(), wt.data_ptr(),
        out.data_ptr(), bsz, m, h, _READER_CODE[reader], _stream(packed),
        variant=reader)
    return out


def first_layer_bwd_cuda(packed, dh, compute_dtype=torch.bfloat16):
    """Launch csrc/first_layer.cu's backward -> (dW_r, dW_m)."""
    _, bwd, parts = _KERNELS[as_dtype(compute_dtype)]
    bsz, m = packed.shape
    h = dh.shape[1]
    dev = packed.device
    dwr = torch.empty((m, h), dtype=torch.float32, device=dev)
    dwm = torch.empty((m, h), dtype=torch.float32, device=dev)
    dht = torch.empty((parts * _up(h, TILE_N) * _up(bsz, CHUNK),),
                      dtype=torch.bfloat16, device=dev)
    reader = code_reader(packed)
    bwd(packed.data_ptr(), dh.data_ptr(), dht.data_ptr(), dwr.data_ptr(),
        dwm.data_ptr(), bsz, m, h, bwd_plan(bsz, m, h)["rows_per_split"],
        _READER_CODE[reader], _stream(packed), variant=reader)
    return dwr, dwm


class _FirstLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, w_r, w_m, cd):
        ctx.save_for_backward(packed)
        ctx.cd = cd
        if packed.is_cuda:
            return first_layer_fwd_cuda(packed, w_r, w_m, cd)
        return first_layer_plain(packed, w_r, w_m, cd)

    @staticmethod
    def backward(ctx, dh):
        (packed,) = ctx.saved_tensors
        dh = dh.float().contiguous()
        if packed.is_cuda:
            dwr, dwm = first_layer_bwd_cuda(packed, dh, ctx.cd)
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
        if cd not in _KERNELS:
            raise NotImplementedError(
                f"the CUDA first-layer kernels take compute_dtype bfloat16 or "
                f"float32, got {cd}")
        packed, w_r, w_m = (packed.contiguous(), w_r.contiguous(),
                            w_m.contiguous())
    elif packed.device.type != "cpu":
        raise ValueError(f"no kernel for device {packed.device}")
    return _FirstLayer.apply(packed, w_r, w_m, cd)
