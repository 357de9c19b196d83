"""The split-bf16 arithmetic of the deep link's f32 kernel at H = 128,
256, 384 and 512 (csrc/deep_link_f32.cu, deep_link_f32_mma_kernel and
deep_link_f32_cluster_kernel<H>) against the JAX package's f32 mode, on
the CPU.

The kernel keeps its three pairwise products (pre2 = h1 W2, dW2 = h1^T
dpre2, dh1 = dpre2 W2^T) at f32 accuracy on the bf16 tensor cores: each f32
operand is split into three bf16 parts (hi = bf16(x), mid = bf16(x - hi),
lo = bf16(x - hi - mid), round to nearest), each k-step of 16 takes the
six part products hi.lo, mid.mid, lo.hi, hi.mid, mid.hi and hi.hi from a
zero sum, and the k-steps add into the running f32 sum. `split_matmul`
emulates that in PyTorch (bf16 casts round to nearest even; every product
of two bf16 parts is exact in f32), and `fused_deep_split` puts it into the
arithmetic of the plain version `pallas_deep.fused_deep_plain`. Through
the port's op (the emulation in place of the plain version), the loglik
and every gradient under a non-uniform cotangent must agree with JAX's
`masked_loglik_deep_packed_train(..., f32_dots=True)` in interpret mode to
1e-5 of each output's largest magnitude, the tolerance of the f32 mode in
tests/test_torch_deep.py (both sides then differ only in the order of
f32 sums and in the split's dropped terms, below 2^-24 of a product). One
bf16 rounding of each operand (hi.hi alone, the bf16 kernel's arithmetic)
misses that tolerance.

dbo, the output bias's gradient, is a sum of +-dlogit over every observed
cell. At 40 x 33 with K = 1 that sum cancels to about 4e-4 of the sum of
its magnitudes, so f32 holds neither package's dbo to 1e-5 of itself
(JAX's read 1e-5 of itself, the split's 3e-6). Every case holds dbo from
both packages against the same sum in f64 from the same inputs, within the
f32 rounding of the sum of its magnitudes: one unit in the last place of
f32 at |g0| sum |dlogit| (g0 the first cotangent, the op's uniform
contract); that case holds it so in place of the 1e-5.

The kernels recompute in f64 a pre2 within the hinge of 0 (HINGE at H =
128, deep_hinge(H) at 256-512, both read from the kernel's source), so
that its relu branch is the exact sum's: the emulated split's pre2 must lie within hinge max_k h1_k sum_k |W2_kn|
of the f64 sum at every width, on a random draw and on one whose
positive terms b2 cancels; one bf16 rounding of each operand does not.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vibo_tpu.models import networks as jnet
from vibo_tpu.ops import pallas_deep as jpd
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.ops import _build, pallas_deep
from vibo_tpu_torch.ops.packing import decode_packed

D, H = 16, 128
WIDE = (256, 384, 512)                # the cluster kernel's widths
K_STEP = 16                           # the kernel's k-step
# (a part, b part) of the split's products, in the kernel's order
SPLIT = ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))
ONE_ROUNDING = ((0, 0),)              # one bf16 rounding of each operand
CANCELLING = (40, 33, 1)              # dbo cancels there (module doc)
DBO = 6                               # dbo's error: after ll, dtheta, dd
#                                       and b1, layer2's b and w


def split_parts(x):
    """x as hi, mid, lo: bf16 values carried in f32, summing to x."""
    parts = []
    for _ in range(3):
        p = x.to(torch.bfloat16).float()
        parts.append(p)
        x = x - p
    return parts


def split_matmul(a, b, products=SPLIT):
    """a (..., n) @ b (n, m) as the kernel forms it: each k-step's part
    products from zero, added to the running f32 sum."""
    pa, pb = split_parts(a), split_parts(b)
    out = a.new_zeros(a.shape[:-1] + b.shape[1:])
    for k0 in range(0, a.shape[-1], K_STEP):
        ks = slice(k0, k0 + K_STEP)
        fresh = sum(pa[i][..., ks] @ pb[j][ks] for i, j in products)
        out = out + fresh
    return out


def fused_deep_split(t1, t2, w2, b2, wo, bo, packed, f32_dots=True,
                     products=SPLIT):
    """fused_deep_plain's outputs with its three products through
    split_matmul (one block of items)."""
    assert f32_dots
    with torch.no_grad():
        h = t1.shape[1]
        mask, resp = decode_packed(packed)
        pre1 = t1[:, None, :] + t2[None, :, :]                 # (B, M, H)
        h1 = pre1.clamp(min=0.0)
        pre2 = split_matmul(h1, w2, products) + b2
        h2 = pre2.clamp(min=0.0)
        logit = (h2 * wo).sum(-1) + bo
        ex = torch.exp(-logit.abs())
        sp = torch.log1p(ex) + logit.clamp(min=0.0)
        ll = (-mask * torch.where(resp > 0.5, sp - logit, sp)).sum(-1)
        inv = 1.0 / (1.0 + ex)
        dl = mask * (resp - torch.where(logit >= 0, inv, 1.0 - inv))
        dpre2 = torch.where(pre2 > 0, dl[..., None] * wo, 0.0)
        dw2 = split_matmul(h1.reshape(-1, h).T, dpre2.reshape(-1, h),
                           products)
        dpre1 = torch.where(pre1 > 0, split_matmul(dpre2, w2.T, products),
                            0.0)
        return (ll, dpre1.sum(1), dpre1.sum(0), dw2, dpre2.sum((0, 1)),
                (h2 * dl[..., None]).sum((0, 1)), dl.sum().reshape(1))


def _dbo_f64(theta, d, link, resp, mask, g):
    """dbo from the inputs in f64, and the sum of its terms' magnitudes:
    g0 sum dlogit and |g0| sum |dlogit| over the observed cells."""
    lk = jax.tree.map(lambda x: np.asarray(x, np.float64), link)
    pre1 = (theta @ lk["w_theta"] + lk["b1"])[:, None] + d @ lk["w_item"]
    h2 = np.maximum(np.maximum(pre1, 0.0) @ lk["layer2"]["w"]
                    + lk["layer2"]["b"], 0.0)
    logit = h2 @ lk["out"]["w"][:, 0] + lk["out"]["b"][0]
    dl = mask * (resp - 1.0 / (1.0 + np.exp(-logit)))
    return float(g[0]) * dl.sum(), abs(float(g[0])) * np.abs(dl).sum()


def _rel_errs(b, m, k, products, monkeypatch, seed=7, h=H):
    """Max error of each output of the port's op (the emulation in place
    of the plain version) against JAX's f32 mode, over its largest
    magnitude: ll, dtheta, dd and the seven link gradients (sorted keys:
    dbo at DBO); and dbo's errors against f64 (JAX's, the port's) with the f32 rounding of
    |g0| sum |dlogit|."""
    rng = np.random.default_rng(seed)
    link = jnet.init_deep_link(jax.random.key(seed), k, D, h)
    link = jax.tree.map(lambda x: x + jnp.asarray(
        0.05 * rng.standard_normal(x.shape).astype(np.float32)), link)
    theta = rng.standard_normal((b, k)).astype(np.float32)
    d = rng.standard_normal((m, D)).astype(np.float32)
    resp = (rng.random((b, m)) < 0.5).astype(np.float32)
    mask = (rng.random((b, m)) < 0.8).astype(np.float32)
    mask[1] = 0.0                                        # an all-missing row
    packed = jpack(resp, mask)
    g = (2.0 * rng.random(b) - 0.5).astype(np.float32)

    def jcall(th, dd, lk):
        return jpd.masked_loglik_deep_packed_train(
            th, dd, lk, jnp.asarray(packed), interpret=True, f32_dots=True)

    jll, vjp = jax.vjp(jcall, jnp.asarray(theta), jnp.asarray(d), link)
    jgrads = vjp(jnp.asarray(g))

    monkeypatch.setattr(pallas_deep, "fused_deep_plain",
                        lambda *a, f32_dots: fused_deep_split(
                            *a, f32_dots=f32_dots, products=products))
    params = params_from_jax(jax.tree.map(np.asarray, link), "cpu")
    th = torch.tensor(theta, requires_grad=True)
    dd = torch.tensor(d, requires_grad=True)
    ll = pallas_deep.masked_loglik_deep_packed_train(
        th, dd, params, torch.from_numpy(packed), f32_dots=True)
    (ll * torch.from_numpy(g)).sum().backward()
    assert float(ll[1].detach()) == 0.0 and not th.grad[1].any()
    pairs = [(ll.detach(), jll), (th.grad, jgrads[0]), (dd.grad, jgrads[1])]
    pairs += list(zip([p.grad for p in tree_leaves(params)],
                      jax.tree.leaves(jgrads[2])))
    assert len(pairs) == 10 and pairs[DBO][0] is params["out"]["b"].grad
    errs = []
    for got, want in pairs:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape
        errs.append(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    ref, magnitude = _dbo_f64(theta.astype(np.float64), d.astype(np.float64),
                              link, resp, mask, g)
    dbo = (abs(float(np.asarray(jgrads[2]["out"]["b"]).ravel()[0]) - ref),
           abs(float(params["out"]["b"].grad.ravel()[0]) - ref),
           float(np.spacing(np.float32(magnitude))))
    return errs, dbo


RAGGED = (37, 150, 2)              # padded to JAX's blocks
CASES = [
    (24, 70, 2),
    RAGGED,
    (40, 70, 1),                  # more students than a kernel block
    CANCELLING,
]


# the ragged case at H = 128 only: JAX's padding does not depend on H, and
# at 256-512 it takes 1.5-2 minutes a width beside the suite's other workers
@pytest.mark.parametrize("b,m,k,h", [
    *[pytest.param(*c, H, id="-".join(map(str, c))) for c in CASES],
    *[pytest.param(*c, w, id="-".join(map(str, c)) + f"-H{w}")
      for w in WIDE for c in CASES if c != RAGGED],
])
def test_split_products_match_pallas_f32(b, m, k, h, monkeypatch):
    errs, (jax_dbo, port_dbo, rounding) = _rel_errs(b, m, k, SPLIT,
                                                    monkeypatch, h=h)
    cancelling = (b, m, k) == CANCELLING
    held = [e for i, e in enumerate(errs) if not (cancelling and i == DBO)]
    assert max(held) <= 1e-5, errs
    assert jax_dbo <= rounding and port_dbo <= rounding, \
        (jax_dbo, port_dbo, rounding)


def test_one_bf16_rounding_misses_the_f32_tolerance(monkeypatch):
    """The test has teeth: the bf16 kernel's arithmetic (each operand
    rounded to bf16 once) is 10x or more past the f32 mode's tolerance."""
    errs, _ = _rel_errs(24, 70, 2, ONE_ROUNDING, monkeypatch)
    assert max(errs) > 1e-4, errs


def test_split_parts_sum_to_the_operand():
    """hi + mid + lo is x exactly (in f64) for f32 values across
    magnitudes, and each part is a bf16 value."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-6, 6, 4096)
                          ).astype(np.float32))
    parts = split_parts(x)
    assert torch.equal(sum(p.double() for p in parts), x.double())
    for p in parts:
        assert torch.equal(p.to(torch.bfloat16).float(), p)


def _hinge_draws(h):
    """(h1 (R, h), W2 (h, h), b2 (h)) in f32: a random draw (half of h1
    at 0, as relu leaves it) and one whose terms are all positive and large
    with b2 cancelling row 0's sum exactly in f64 (pre2 ~ 0 where sum_k
    h1_k |W2_kn| is largest)."""
    rng = np.random.default_rng(h)
    h1 = np.maximum(rng.standard_normal((64, h)), 0.0).astype(np.float32)
    w2 = (rng.standard_normal((h, h)) / np.sqrt(h)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(h)).astype(np.float32)
    yield h1, w2, b2
    h1 = rng.uniform(50.0, 100.0, (64, h)).astype(np.float32)
    w2 = rng.uniform(0.5, 1.0, (h, h)).astype(np.float32)
    h1[1:] = h1[0] * rng.uniform(0.999, 1.001, (63, h)).astype(np.float32)
    b2 = (-(h1[0].astype(np.float64) @ w2.astype(np.float64))
          ).astype(np.float32)
    yield h1, w2, b2


def _source_hinge(h):
    """The split's hinge at width h as csrc/deep_link_f32.cu defines it
    (HINGE at 128, deep_hinge(H) at 256-512), evaluated from the source's
    text, so that the test and the kernel cannot drift apart."""
    src = (_build.CSRC_DIR / "deep_link_f32.cu").read_text()
    if h == H:
        found = re.search(r"constexpr float HINGE = ([^;]+);", src)
    else:
        found = re.search(r"constexpr float deep_hinge\(int H\) \{\s*"
                          r"return ([^;]+);", src)
    assert found, "the hinge's definition is not in the source"
    expr = re.sub(r"(\d+\.\d*)f\b", r"\1", found.group(1))
    expr = re.sub(r"\bH\b", str(h), expr)
    assert re.fullmatch(r"[\d.\s()*/+\-]+", expr), expr
    return float(eval(expr))    # digits and arithmetic only (checked)


@pytest.mark.parametrize("h", [H, *WIDE])
def test_split_pre2_lies_within_the_hinge(h):
    """|split pre2 - exact| <= hinge(h) max_k h1_k sum_k |W2_kn| for every
    value, the hinge read from csrc/deep_link_f32.cu; one bf16 rounding of
    each operand is past it (the bound is tighter than bf16's error)."""
    hinge = _source_hinge(h)
    assert 0.0 < hinge < 2.0 ** -16
    for h1, w2, b2 in _hinge_draws(h):
        exact = (h1.astype(np.float64) @ w2.astype(np.float64)
                 + b2.astype(np.float64))
        bound = hinge * h1.max(1, keepdims=True) * np.abs(w2).sum(0)
        t1, tw, tb = map(torch.from_numpy, (h1, w2, b2))
        split = (split_matmul(t1, tw) + tb).numpy().astype(np.float64)
        assert (np.abs(split - exact) <= bound).all(), \
            float((np.abs(split - exact) / bound).max())
        one = (split_matmul(t1, tw, ONE_ROUNDING) + tb).numpy()
        assert (np.abs(one - exact) > bound).any()
