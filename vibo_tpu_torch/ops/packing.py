"""The int8 response code: 0 = missing, 1 + category otherwise (binary links:
1 = observed wrong, 2 = observed right; grm/gpcm: 1..C for categories
0..C-1).

One byte per cell instead of two f32 matrices (response and mask): the
training step's only response-sized read. Counterpart of
`vibo_tpu.ops.pallas_elbo.pack_responses` / `_decode_packed` and
`vibo_tpu.ops.pallas_encoder.packed_row_valid`.
"""

from __future__ import annotations

import numpy as np
import torch

from vibo_tpu_torch._device import resolve_device


def pack_responses(resp, mask):
    """(response, mask) -> int8 code mask * (1 + resp).

    numpy in -> numpy out (streamed in row blocks, so no matrix-sized f32
    temporaries); torch in -> torch out on the same device."""
    if isinstance(resp, np.ndarray):
        n, m = resp.shape
        out = np.empty((n, m), np.int8)
        block = max(1, (1 << 24) // max(1, m))
        for s in range(0, n, block):
            e = min(n, s + block)
            np.copyto(out[s:e], mask[s:e] * (1.0 + resp[s:e]),
                      casting="unsafe")
        return out
    return (mask * (1.0 + resp)).to(torch.int8)


def packed_on_device(response: np.ndarray, mask: np.ndarray, device=None):
    """Host (response, mask) -> (int8 code, (B,) f32 row validity) on the
    device (None = cuda). The code is the only response-sized tensor the
    training step reads."""
    dev = resolve_device(device)
    packed = torch.from_numpy(pack_responses(response, mask)).to(dev)
    return packed, packed_row_valid(packed)


def decode_packed(packed: torch.Tensor, dtype=torch.float32):
    """int8 code -> (mask, resp) in `dtype` (mask 0/1, resp the category:
    small integers, exact in bf16)."""
    pk = packed.to(dtype)
    return pk.clamp(max=1.0), (pk - 1.0).clamp(min=0.0)


def packed_row_valid(packed: torch.Tensor) -> torch.Tensor:
    """(B,) f32 indicator of rows with any observed cell."""
    return (packed.to(torch.int32).sum(-1) > 0).to(torch.float32)
