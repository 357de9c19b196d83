"""Masked 2PL Bernoulli log-likelihood ops (counterpart of
`vibo_tpu.ops.pallas_elbo`, same module name), each a
`torch.autograd.Function` with its Pallas op's custom-VJP contract:

  masked_loglik_2pl                 theta, a, b, resp, mask -> ll (B,)
  masked_loglik_2pl_packed          theta, a, b, int8 code  -> ll (B,)
  masked_loglik_2pl_packed_train_t  thetaT (K, B) -> scalar sum_i ll_i
  masked_loglik_2pl_packed_train    theta (B, K)  -> per-person ll (B,)

The first two are the general op: its VJP is exact for any per-person
cotangent, and a leading sample axis (theta (S, B, K), with a, b and the
data each per-sample or shared) runs as one launch. On a CUDA tensor they
run csrc/masked_loglik_2pl.cu, one source templated on the cell reader
(dense f32 resp/mask, or the int8 code).

The training ELBO on the code only consumes ll.sum(), so the last two take
the value and all gradients from ONE pass over the code (one exp and one
log1p per cell): the kernel emits (ll, dtheta, da, db) and the backward only
rescales them. On a CUDA tensor both layouts run csrc/loglik_2pl.cu (theta
addressed through its strides, so no transpose is copied).

On a CPU tensor each op runs the plain PyTorch version beside its kernel.
Nothing else falls back.
"""

from __future__ import annotations

import ctypes

import torch

from vibo_tpu_torch.ops import _build
from vibo_tpu_torch.ops._build import I, P
from vibo_tpu_torch.ops.packing import decode_packed

L = ctypes.c_longlong

TRAIN = _build.register(_build.Kernel(
    "loglik_2pl_train", "loglik_2pl.cu", "loglik_2pl_train",
    [P, L, L, P, P, P, P, L, L, P, P, P, P, P, P, P, I, I, I, I, P]))
MASKED_FWD = _build.register(_build.Kernel(
    "masked_loglik_2pl_fwd", "masked_loglik_2pl.cu", "masked_loglik_2pl_fwd",
    [P, P, L, P, L, P, P, P, L, P, I, I, I, I, P]))
MASKED_BWD = _build.register(_build.Kernel(
    "masked_loglik_2pl_bwd", "masked_loglik_2pl.cu", "masked_loglik_2pl_bwd",
    [P, P, P, L, P, L, P, P, P, L, P, P, P, P, P, I, I, I, I, I, P]))
MAX_K = 8                   # the kernels are instantiated for K = 1..8
STUDENTS_PER_BLOCK = 64     # TBS in csrc/loglik_2pl.cu: scratch rows
MASKED_BWD_STUDENTS = 32    # BWD_TBS in csrc/masked_loglik_2pl.cu


def loglik_2pl_train_plain(theta, a, b, packed):
    """Plain version of the kernel: theta (B, K) -> (ll (B,), dtheta (B, K),
    da (M, K), db (M,)), dense logits and closed-form gradients of sum(ll)."""
    with torch.no_grad():
        m, r = decode_packed(packed)
        logits = theta @ a.T - b
        e = torch.exp(-logits.abs())
        sp = torch.log1p(e) + logits.clamp(min=0.0)       # softplus(l)
        # r in {0, 1}: r*l - softplus(l) == -softplus((1-2r) l)
        ll = (-m * torch.where(r > 0.5, sp - logits, sp)).sum(-1)
        inv = 1.0 / (1.0 + e)
        s = torch.where(logits >= 0, inv, 1.0 - inv)     # sigmoid(l)
        dl = m * (r - s)
        return ll, dl @ a, dl.T @ theta, -dl.sum(0)


def loglik_2pl_train_cuda(theta, a, b, packed, dtheta, per_person: bool):
    """Launch csrc/loglik_2pl.cu on theta (B, K) of any strides, writing
    dtheta (a (B, K) view of a preallocated buffer) through its strides.
    Returns (ll, da, db): ll is (B,) if per_person else a scalar."""
    bsz, k = theta.shape
    m = a.shape[0]
    dev = theta.device
    nblk = -(-bsz // STUDENTS_PER_BLOCK)
    f32 = dict(dtype=torch.float32, device=dev)
    part_da = torch.empty((nblk, m, k), **f32)
    part_db = torch.empty((nblk, m), **f32)
    part_ll = torch.empty((nblk,), **f32)
    ll_person = torch.empty((bsz,), **f32) if per_person else None
    da = torch.empty((m, k), **f32)
    db = torch.empty((m,), **f32)
    ll = torch.empty((1,), **f32)
    TRAIN(theta.data_ptr(), theta.stride(0), theta.stride(1), a.data_ptr(),
          b.data_ptr(), packed.data_ptr(), dtheta.data_ptr(),
          dtheta.stride(0), dtheta.stride(1),
          None if ll_person is None else ll_person.data_ptr(),
          part_da.data_ptr(), part_db.data_ptr(), part_ll.data_ptr(),
          da.data_ptr(), db.data_ptr(), ll.data_ptr(), bsz, m, k, nblk,
          torch.cuda.current_stream(dev).cuda_stream)
    return (ll_person if per_person else ll[0]), da, db


class _TrainT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, thetaT, a, b, packed):
        if thetaT.is_cuda:
            dthT = torch.empty(thetaT.shape, dtype=torch.float32,
                               device=thetaT.device)
            ll, da, db = loglik_2pl_train_cuda(thetaT.T, a, b, packed,
                                               dthT.T, per_person=False)
        else:
            ll, dth, da, db = loglik_2pl_train_plain(thetaT.T, a, b, packed)
            ll, dthT = ll.sum(), dth.T
        ctx.save_for_backward(dthT, da, db)
        return ll

    @staticmethod
    def backward(ctx, g):
        dthT, da, db = ctx.saved_tensors
        return g * dthT, g * da, g * db, None


class _Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, a, b, packed):
        if theta.is_cuda:
            dth = torch.empty(theta.shape, dtype=torch.float32,
                              device=theta.device)
            ll, da, db = loglik_2pl_train_cuda(theta, a, b, packed, dth,
                                               per_person=True)
        else:
            ll, dth, da, db = loglik_2pl_train_plain(theta, a, b, packed)
        ctx.save_for_backward(dth, da, db)
        return ll

    @staticmethod
    def backward(ctx, g):
        dth, da, db = ctx.saved_tensors
        g0 = g.reshape(-1)[0]  # uniform-cotangent contract (module doc)
        return g[:, None] * dth, g0 * da, g0 * db, None


def _prepare(theta, a, b, packed, k_axis: int):
    """Validate and cast: f32 theta/a/b, int8 code, one device, K bound."""
    if packed.dtype != torch.int8 or packed.ndim != 2:
        raise ValueError(f"packed must be a (B, M) int8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    devices = {t.device for t in (theta, a, b, packed)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    bsz, m = packed.shape
    k = theta.shape[k_axis]
    if (theta.ndim != 2 or theta.shape[1 - k_axis] != bsz
            or a.shape != (m, k) or b.shape != (m,)):
        raise ValueError(f"shapes theta {tuple(theta.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)} do not match "
                         f"packed {tuple(packed.shape)}")
    theta, a, b = theta.float(), a.float(), b.float()
    if packed.is_cuda:
        if not 1 <= k <= MAX_K:
            raise ValueError(f"the CUDA loglik kernel takes 1 <= K <= "
                             f"{MAX_K}, got K={k}")
        a, b, packed = a.contiguous(), b.contiguous(), packed.contiguous()
    elif packed.device.type != "cpu":
        raise ValueError(f"no kernel for device {packed.device}")
    return theta, a, b, packed


def masked_loglik_2pl_packed_train_t(thetaT: torch.Tensor, a: torch.Tensor,
                                     b: torch.Tensor, packed: torch.Tensor
                                     ) -> torch.Tensor:
    """Transposed-theta one-pass 2PL training loglik: thetaT (K, B) ->
    SCALAR sum_i ll_i. The scalar output makes the uniform-cotangent contract
    exact by construction: the backward scales (dthetaT, da, db) by g."""
    thetaT, a, b, packed = _prepare(thetaT, a, b, packed, k_axis=0)
    return _TrainT.apply(thetaT, a, b, packed)


def masked_loglik_2pl_packed_train(theta: torch.Tensor, a: torch.Tensor,
                                   b: torch.Tensor, packed: torch.Tensor
                                   ) -> torch.Tensor:
    """One-pass training variant of the masked 2PL loglik -> (B,).

    Value-identical to the general op; gradients are precomputed in the same
    kernel pass under the UNIFORM-COTANGENT CONTRACT: the caller must only
    use this where every person's loglik gets the same weight (e.g. followed
    by .sum() into a scalar loss, as in elbo_packed_sums).
    dtheta is exact for any cotangent; da/db assume uniformity."""
    theta, a, b, packed = _prepare(theta, a, b, packed, k_axis=1)
    return _Train.apply(theta, a, b, packed)


# ------------------------------------------- general masked 2PL loglik
#
# Internally every array carries a leading sample axis: theta (S, B, K),
# a (Sa, M, K), b (Sb, M), resp/mask/packed (Sd, B, M), each of Sa, Sb, Sd
# either S or 1 (shared over the samples).


def masked_loglik_2pl_plain(theta, a, b, resp, mask):
    """Plain version of the forward kernel -> ll (S, B): dense logits and
    the closed form m * (r*l - softplus(l)), softplus in its stable form."""
    with torch.no_grad():
        logits = theta @ a.transpose(-1, -2) - b[:, None, :]
        sp = torch.log1p(torch.exp(-logits.abs()))
        return (mask * ((resp * logits - logits.clamp(min=0.0)) - sp)).sum(-1)


def masked_loglik_2pl_vjp_plain(g, theta, a, b, resp, mask):
    """Plain version of the backward kernel: the VJP of
    masked_loglik_2pl_plain for the cotangent g (S, B) -> (dtheta (S, B, K),
    da (Sa, M, K), db (Sb, M)); a shared a or b sums over the samples."""
    with torch.no_grad():
        logits = theta @ a.transpose(-1, -2) - b[:, None, :]
        dl = g[..., None] * (mask * (resp - torch.sigmoid(logits)))
        da = dl.transpose(-1, -2) @ theta
        db = -dl.sum(-2)
        if a.shape[0] < theta.shape[0]:
            da = da.sum(0, keepdim=True)
        if b.shape[0] < theta.shape[0]:
            db = db.sum(0, keepdim=True)
        return dl @ a, da, db


def _sample_stride(x, s: int) -> int:
    """Elements between two samples of x, 0 when x is shared over them."""
    return 0 if x.shape[0] == 1 and s > 1 else x[0].numel()


def _data_args(resp, mask, packed):
    """(resp, mask, packed) pointers for the kernel's cell reader, its
    sample stride and the reader's name."""
    if packed is not None:
        return None, None, packed.data_ptr(), packed, "int8"
    return resp.data_ptr(), mask.data_ptr(), None, resp, "dense"


def masked_loglik_2pl_fwd_cuda(theta, a, b, resp, mask, packed):
    """Launch the forward kernel: ll (S, B). Pass (resp, mask) with packed
    None for the dense reader, or packed with resp and mask None."""
    s, bsz, k = theta.shape
    m = a.shape[1]
    ll = torch.empty((s, bsz), dtype=torch.float32, device=theta.device)
    rp, mp, pp, data, reader = _data_args(resp, mask, packed)
    MASKED_FWD(theta.data_ptr(), a.data_ptr(), _sample_stride(a, s),
               b.data_ptr(), _sample_stride(b, s), rp, mp, pp,
               _sample_stride(data, s), ll.data_ptr(), s, bsz, m, k,
               torch.cuda.current_stream(theta.device).cuda_stream,
               variant=reader)
    return ll


def masked_loglik_2pl_bwd_cuda(g, theta, a, b, resp, mask, packed):
    """Launch the backward kernels for the cotangent g (S, B):
    (dtheta (S, B, K), da (Sa, M, K), db (Sb, M))."""
    s, bsz, k = theta.shape
    m = a.shape[1]
    dev = theta.device
    f32 = dict(dtype=torch.float32, device=dev)
    nblk = -(-bsz // MASKED_BWD_STUDENTS)
    dtheta = torch.empty((s, bsz, k), **f32)
    part_da = torch.empty((s * nblk, m, k), **f32)
    part_db = torch.empty((s * nblk, m), **f32)
    da = torch.empty(a.shape, **f32)
    db = torch.empty(b.shape, **f32)
    rp, mp, pp, data, reader = _data_args(resp, mask, packed)
    MASKED_BWD(g.data_ptr(), theta.data_ptr(), a.data_ptr(),
               _sample_stride(a, s), b.data_ptr(), _sample_stride(b, s),
               rp, mp, pp, _sample_stride(data, s), dtheta.data_ptr(),
               part_da.data_ptr(), part_db.data_ptr(), da.data_ptr(),
               db.data_ptr(), s, bsz, m, k, nblk,
               torch.cuda.current_stream(dev).cuda_stream, variant=reader)
    return dtheta, da, db


class _Masked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, a, b, resp, mask, packed):
        ctx.save_for_backward(theta, a, b, resp, mask, packed)
        if theta.is_cuda:
            return masked_loglik_2pl_fwd_cuda(theta, a, b, resp, mask, packed)
        if packed is not None:
            mask, resp = decode_packed(packed)
        return masked_loglik_2pl_plain(theta, a, b, resp, mask)

    @staticmethod
    def backward(ctx, g):
        theta, a, b, resp, mask, packed = ctx.saved_tensors
        if theta.is_cuda:
            grads = masked_loglik_2pl_bwd_cuda(g.contiguous(), theta, a, b,
                                               resp, mask, packed)
        else:
            if packed is not None:
                mask, resp = decode_packed(packed)
            grads = masked_loglik_2pl_vjp_plain(g, theta, a, b, resp, mask)
        return (*grads, None, None, None)


def _lift(x, ndim: int, name: str):
    """x with a leading sample axis of 1 added when it has ndim - 1 dims."""
    if x.ndim == ndim - 1:
        return x.unsqueeze(0)
    if x.ndim != ndim:
        raise ValueError(f"{name} must have {ndim - 1} or {ndim} dims, got "
                         f"shape {tuple(x.shape)}")
    return x


def _masked_call(theta, a, b, resp, mask, packed):
    """Validate, cast to f32, give every array a sample axis, run _Masked
    and drop the axis again when theta had none."""
    data = [x for x in (resp, mask, packed) if x is not None]
    devices = {t.device for t in (theta, a, b, *data)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    batched = theta.ndim == 3
    theta = _lift(theta.float(), 3, "theta")
    a, b = _lift(a.float(), 3, "a"), _lift(b.float(), 2, "b")
    if packed is None:
        resp, mask = _lift(resp.float(), 3, "resp"), _lift(mask.float(), 3,
                                                            "mask")
        data = [resp, mask]
    else:
        data = [_lift(packed, 3, "packed")]
    s, bsz, k = theta.shape
    m = a.shape[1]
    ok = (a.shape[1:] == (m, k) and b.shape[1:] == (m,)
          and all(x.shape[1:] == (bsz, m) for x in data)
          and all(x.shape[0] in (1, s) for x in (a, b, *data)))
    if not ok:
        raise ValueError(
            f"shapes theta {tuple(theta.shape)}, a {tuple(a.shape)}, b "
            f"{tuple(b.shape)}, data {[tuple(x.shape) for x in data]} do not "
            "match (leading sample axes must equal theta's or be absent)")
    if dev.type == "cuda":
        if not 1 <= k <= MAX_K:
            raise ValueError(f"the CUDA loglik kernels take 1 <= K <= "
                             f"{MAX_K}, got K={k}")
        theta, a, b = theta.contiguous(), a.contiguous(), b.contiguous()
        data = [x.contiguous() for x in data]
    if packed is None:
        ll = _Masked.apply(theta, a, b, data[0], data[1], None)
    else:
        ll = _Masked.apply(theta, a, b, None, None, data[0])
    return ll if batched else ll[0]


def masked_loglik_2pl(theta: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      resp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-person masked 2PL Bernoulli log-likelihood.

    theta (B, K), a (M, K), b (M,), resp/mask (B, M) -> (B,); with a leading
    sample axis theta (S, B, K) -> (S, B), and a (S, M, K), b (S, M),
    resp/mask (S, B, M) each per-sample or without the axis (shared).
    Semantics == likelihood.masked_loglik_per_person(links.logits_2pl(...)).
    Differentiable in theta, a and b, exact for any cotangent. theta, a, b,
    resp and mask are cast to f32, as the JAX op casts them."""
    return _masked_call(theta, a, b, resp, mask, None)


def masked_loglik_2pl_packed(theta: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, packed: torch.Tensor
                             ) -> torch.Tensor:
    """masked_loglik_2pl on the int8 code (packing.pack_responses) instead
    of (resp, mask): same values and gradients, 1 byte a cell instead of 8."""
    if packed.dtype != torch.int8:
        raise ValueError(f"packed must be an int8 tensor, got {packed.dtype}")
    return _masked_call(theta, a, b, None, None, packed)
