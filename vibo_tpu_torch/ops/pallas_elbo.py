"""One-pass fused 2PL training log-likelihood on the int8 response code.

Counterpart of the training kernels of `vibo_tpu.ops.pallas_elbo` (same
module name):

  masked_loglik_2pl_packed_train_t  thetaT (K, B) -> scalar sum_i ll_i
  masked_loglik_2pl_packed_train    theta (B, K)  -> per-person ll (B,)

The training ELBO only consumes ll.sum(), so the value and all gradients come
from ONE pass over the code (one exp and one log1p per cell): the kernel
emits (ll, dtheta, da, db) and the backward only rescales them. On a CUDA
tensor both layouts run the hand-written kernel of csrc/loglik_2pl.cu
(theta addressed through its strides, so no transpose is copied); on a CPU
tensor the plain PyTorch version below runs. Nothing else falls back.
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
MAX_K = 8                   # the kernel is instantiated for K = 1..8
STUDENTS_PER_BLOCK = 64     # TBS in csrc/loglik_2pl.cu: scratch rows


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
