"""The port's packed first layer (plain version, on the CPU) against
`vibo_tpu.ops.pallas_encoder.packed_first_layer` (Pallas in interpret mode):
the value and dW_r / dW_m through each framework's autograd, on a ragged
shape, on the binary and on a graded code. Tolerances: 1e-5 relative to the
largest magnitude at f32; 1e-3 at bf16 (same bf16 operands on both sides,
f32 sums in different orders). Also the CUDA kernels' host-side pieces: the
exact three-way bf16 split of the f32 mode (its Python twin, bit for bit),
the backward's launch plan and the code reader's choice."""

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
    """The backward kernel's launch plan: every student in exactly one CTA
    of a cluster, in runs of a multiple of the chunk depth, and every output
    element in exactly one tile; the plan does not read the card (sms is
    the SM count the former split plan took)."""
    plan = pallas_encoder.bwd_plan(bsz, m, h)
    rows = plan["rows_per_split"]
    tm, tn, z = plan["grid"]
    assert z == pallas_encoder.CLUSTER and rows % pallas_encoder.CHUNK == 0
    owner = np.zeros(bsz, np.int64)
    for rank in range(z):
        owner[rank * rows:min(bsz, (rank + 1) * rows)] += 1
    assert (owner == 1).all()
    cover = np.zeros((m, h), np.int64)
    for i in range(tm):
        for j in range(tn):
            cover[i * pallas_encoder.BWD_TILE_M:(i + 1) * pallas_encoder.BWD_TILE_M,
                  j * pallas_encoder.TILE_N:(j + 1) * pallas_encoder.TILE_N] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_packed_first_layer_graded_code(dtype, tol):
    """A GRM/GPCM code (0 = missing, 1 + category up to 32): rm reaches 31,
    exact in bf16, decoded by the same min/max."""
    b, m, h = 37, 150, 24
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 33, (b, m)).astype(np.int8)
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


def _split_values():
    rng = np.random.default_rng(6)
    normal = (rng.standard_normal(4096)
              * np.exp2(rng.integers(-100, 100, 4096))).astype(np.float32)
    bits = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    raw = bits.view(np.float32)
    raw = raw[np.isfinite(raw) & (np.abs(raw) >= np.float32(2.0**-110))]
    edge = np.array([0.0, -0.0, 3.4028235e38, -3.4028235e38, 1.0, -1.0,
                     np.float32(2.0**-110), np.float32(2.0**-126),
                     np.float32(2.0**-130), np.float32(-2.0**-133),
                     np.float32(3 * 2.0**-133)], np.float32)
    return np.concatenate([normal, raw, edge]).astype(np.float32)


@pytest.mark.parametrize("values", ["random", "extremes"])
def test_split_bf16x3_is_exact(values):
    """hi + mid + lo == w bit for bit, each part a bf16 value, for random
    values, random bit patterns, +-0, +-3.4e38 and the subnormals on bf16's
    grid (multiples of 2^-133); f32 subnormals off that grid lose at most
    their bits under 2^-133."""
    w = _split_values() if values == "random" else np.array(
        [0.0, -0.0, 3.4028235e38, -3.4028235e38, 2.0**-133, -2.0**-130,
         127 * 2.0**-133], np.float32)
    hi, mid, lo = (x.numpy() for x in
                   pallas_encoder.split_bf16x3(torch.from_numpy(w)))
    for part in (hi, mid, lo):
        assert (part.view(np.uint32) & 0xFFFF == 0).all()
    total = hi.astype(np.float64) + mid + lo
    assert np.array_equal(total, w.astype(np.float64))
    assert np.array_equal(np.signbit(hi[w == 0]), np.signbit(w[w == 0]))
    sub = (np.arange(1, 4096, dtype=np.uint32) * 37).view(np.float32)
    parts = pallas_encoder.split_bf16x3(torch.from_numpy(sub))
    err = np.abs(sum(x.numpy().astype(np.float64) for x in parts)
                 - sub.astype(np.float64))
    assert err.max() < 2.0**-133


def test_code_reader_follows_row_alignment():
    """16-byte cp.async where the code's rows are 16-byte aligned, 4-byte
    where they are 4-byte aligned, else byte loads (config 5 has M = 680,
    the odd test shape M = 301)."""
    for m, reader in ((1024, "cp16"), (680, "cp4"), (300, "cp4"),
                      (301, "bytes")):
        pk = torch.zeros((3, m), dtype=torch.int8)
        assert pallas_encoder.code_reader(pk) == reader
    assert pallas_encoder.code_reader(torch.zeros((3, 1025),
                                                  dtype=torch.int8)[:, 1:]) \
        == "bytes"


def test_packed_first_layer_rejects_bad_input():
    pk = torch.zeros((4, 6), dtype=torch.int8)
    w = torch.zeros((6, 3))
    with pytest.raises(ValueError, match="int8"):
        pallas_encoder.packed_first_layer(pk.float(), w, w)
    with pytest.raises(ValueError, match="do not match"):
        pallas_encoder.packed_first_layer(pk, w[:5], w[:5])
