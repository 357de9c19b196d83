"""The port's packed first layer (plain version, on the CPU) against
`vibo_tpu.ops.pallas_encoder.packed_first_layer` (Pallas in interpret mode):
the value and dW_r / dW_m through each framework's autograd, on a ragged
shape. Tolerances: 1e-5 relative to the largest magnitude at f32; 1e-3 at
bf16 (same bf16 operands on both sides, f32 sums in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.ops import pallas_encoder as jenc
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch.ops import pallas_encoder


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
@pytest.mark.parametrize("shape", [(37, 150, 24), (8, 16, 8)])
def test_packed_first_layer_value_and_grads(shape, dtype, tol):
    b, m, h = shape
    rng = np.random.default_rng(0)
    resp = (rng.random((b, m)) < 0.5).astype(np.float32)
    mask = (rng.random((b, m)) < 0.8).astype(np.float32)
    packed = jpack(resp, mask)
    wr = rng.standard_normal((m, h)).astype(np.float32)
    wm = rng.standard_normal((m, h)).astype(np.float32)
    cot = rng.standard_normal((b, h)).astype(np.float32)

    def jf(wr, wm):
        out = jenc.packed_first_layer(jnp.asarray(packed), wr, wm, dtype)
        return (out * cot).sum(), out

    (_, jout), (jdwr, jdwm) = jax.value_and_grad(jf, argnums=(0, 1),
                                                 has_aux=True)(
        jnp.asarray(wr), jnp.asarray(wm))

    twr = torch.tensor(wr, requires_grad=True)
    twm = torch.tensor(wm, requires_grad=True)
    out = pallas_encoder.packed_first_layer(torch.from_numpy(packed), twr,
                                            twm, dtype)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach(), jout, tol)
    _close(twr.grad, jdwr, tol)
    _close(twm.grad, jdwm, tol)


@pytest.mark.parametrize("bsz,m,h,sms", [(10240, 1024, 256, 132),
                                         (1000, 300, 256, 132),
                                         (37, 150, 24, 132), (0, 10, 10, 132),
                                         (10240, 1024, 256, 1)])
def test_bwd_splits_cover_every_student_once(bsz, m, h, sms):
    """The backward kernel's split of the student loop: runs of a multiple
    of the chunk depth, the last one non-empty, together covering B."""
    splits, rows = pallas_encoder.bwd_splits(bsz, m, h, sms)
    assert splits >= 1 and rows % 32 == 0
    assert (splits - 1) * rows < max(bsz, 1) <= splits * rows
    tiles = -(-m // 64) * -(-h // 64)
    assert splits == 1 or tiles * (splits - 1) < 4 * sms


def test_packed_first_layer_rejects_bad_input():
    pk = torch.zeros((4, 6), dtype=torch.int8)
    w = torch.zeros((6, 3))
    with pytest.raises(ValueError, match="int8"):
        pallas_encoder.packed_first_layer(pk.float(), w, w)
    with pytest.raises(ValueError, match="do not match"):
        pallas_encoder.packed_first_layer(pk, w[:5], w[:5])
