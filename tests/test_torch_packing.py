"""The port's data layer and int8 code against the JAX package's, exactly:
`pack_responses` byte-equal (numpy and tensor inputs), the decode and
`packed_row_valid` equal, and `simulate_irt` / `holdout_split` byte-equal
for the same seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.ops import pallas_elbo as jelbo
from vibo_tpu.ops import pallas_encoder as jenc
from vibo_tpu_torch.data import holdout_split, simulate_irt
from vibo_tpu_torch.ops import packing


def test_pack_decode_row_valid_match_jax():
    rng = np.random.default_rng(0)
    resp = (rng.random((50, 33)) < 0.5).astype(np.float32)
    mask = (rng.random((50, 33)) < 0.7).astype(np.float32)
    mask[[4, 17]] = 0.0                                  # all-missing rows
    resp *= mask
    want = jelbo.pack_responses(resp, mask)
    got = packing.pack_responses(resp, mask)
    assert got.dtype == np.int8 and got.tobytes() == np.asarray(want).tobytes()
    got_t = packing.pack_responses(torch.from_numpy(resp),
                                   torch.from_numpy(mask))
    assert got_t.dtype == torch.int8
    assert got_t.numpy().tobytes() == np.asarray(want).tobytes()
    jm, jr = jelbo._decode_packed(jnp.asarray(want).astype(jnp.float32))
    m, r = packing.decode_packed(torch.from_numpy(got))
    assert np.array_equal(m.numpy(), np.asarray(jm))
    assert np.array_equal(r.numpy(), np.asarray(jr))
    rv = packing.packed_row_valid(torch.from_numpy(got)).numpy()
    assert np.array_equal(rv, np.asarray(jenc.packed_row_valid(
        jnp.asarray(want))))
    assert rv[4] == 0.0 and rv[17] == 0.0
    pk, rv2 = packing.packed_on_device(resp, mask, "cpu")
    assert pk.numpy().tobytes() == got.tobytes()
    assert np.array_equal(rv2.numpy(), rv)


@pytest.mark.parametrize("irt_model", ["1pl", "2pl", "3pl", "nonlinear"])
def test_simulate_and_holdout_byte_equal(irt_model):
    kw = dict(ability_dim=3, seed=7, missing_rate=0.2)
    want = jsim(irt_model, 60, 25, **kw)
    got = simulate_irt(irt_model, 60, 25, **kw)
    for f in ("response", "mask", "theta", "a", "b", "prob", "g_hat"):
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
    jds = jholdout(want.response, want.mask, 0.15, seed=3)
    ds = holdout_split(got.response, got.mask, 0.15, seed=3)
    for f in ("response", "train_mask", "heldout_mask"):
        assert getattr(ds, f).tobytes() == getattr(jds, f).tobytes(), f
    assert ds.shape == jds.shape


def test_simulate_out_of_scope_raises():
    with pytest.raises(ValueError, match="supports"):
        simulate_irt("quadratic", 4, 3)
