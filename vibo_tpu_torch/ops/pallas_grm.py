"""One-pass graded (GRM) training loglik (counterpart of
`vibo_tpu.ops.pallas_grm`, same module name), and the one-pass machinery it
shares with `pallas_gpcm`:

  masked_loglik_grm_packed_train   theta (B, K), a (M, K), kappa (M, C-1)
                                   ordered thresholds, int8 code -> ll (B,)

The training ELBO on the code only consumes ll.sum(), so the op takes the
value and every gradient from ONE pass over the code: the kernel emits (ll,
dtheta, da, dkappa) and the backward only rescales them, under the
UNIFORM-COTANGENT CONTRACT of the Pallas op: dtheta is exact for any
per-person cotangent, da and dkappa are scaled by the first cotangent. The
thresholds are reparameterized outside the op (`links.grm_thresholds`), so
autograd chains dkappa through that small (M, C-1) map. A leading sample
axis (theta (S, B, K)) runs one launch a sample, with a and kappa per
sample ((S, M, K), (S, M, C-1)) or shared, on one shared code.

On a CUDA tensor the op runs csrc/loglik_grm.cu (`loglik_grm_train`)
at every C in [3, 32]: at C <= 8 (K <= 8) a prologue writes each item's
thresholds, D and log D once a call (the counterpart of JAX's
`_grm_tables`), and the main kernel takes C at compile time; on a CPU
tensor the plain PyTorch version beside it. Nothing else falls back.
"""

from __future__ import annotations

import ctypes

import torch

from vibo_tpu_torch.ops import _build
from vibo_tpu_torch.ops._build import I, P
from vibo_tpu_torch.ops.one_pass import ITEMS_PER_TILE, split_plan
from vibo_tpu_torch.ops.packing import decode_packed

L = ctypes.c_longlong
ARGTYPES = [P, L, L, P, P, P, P, P, L, L, P, P, P, P, P, I, I, I, I, I, I, I,
            P]
TRAIN = _build.register(_build.Kernel(
    "loglik_grm_train", "loglik_grm.cu", "loglik_grm_train",
    ARGTYPES))
MIN_C, MAX_C = 3, 32        # categories the kernel takes (VIBOConfig's range)

_BIG = 50.0                 # boundary-category sentinel threshold
_CLAMP = 30.0               # base saturation
_GAP_CLAMP = -1e-6          # kappa_r - kappa_{r+1} clamp


def grm_tables(kappa):
    """(M, C-1) ordered thresholds -> (D, log D), each (M, C): D_r = 1 -
    e^(kappa_r - kappa_{r+1}) with the gap clamped to -1e-6, 1 (log 0) on the
    boundary categories; the Pallas op's `_grm_tables`, item-major."""
    gaps = (kappa[:, :-1] - kappa[:, 1:]).clamp(max=_GAP_CLAMP)
    ones = torch.ones_like(kappa[:, :1])
    d = torch.cat([ones, -torch.expm1(gaps), ones], -1)
    ld = torch.cat([torch.zeros_like(ones), torch.log(d[:, 1:-1]),
                    torch.zeros_like(ones)], -1)
    return d, ld


def decode_categories(packed, c: int):
    """int8 code -> (mask, category r as int64 clamped to [0, C-1]), the
    kernels' decode."""
    m, r = decode_packed(packed)
    return m, r.clamp(max=c - 1).long()


def loglik_grm_train_plain(theta, a, kappa, packed):
    """Plain version of the kernel: theta (B, K) -> (ll (B,), dtheta (B, K),
    da (M, K), dkappa (M, C-1)), the closed forms of sum(ll) on dense
    (B, M) cells."""
    with torch.no_grad():
        mm, cm1 = kappa.shape
        m, r = decode_categories(packed, cm1 + 1)
        base = (theta @ a.T).clamp(-_CLAMP, _CLAMP)
        big = torch.full_like(kappa[:, :1], _BIG)
        kx = torch.cat([-big, kappa, big], -1)            # (M, C + 1)
        d, ld = grm_tables(kappa)
        cols = torch.arange(mm, device=kappa.device)
        x, y = base - kx[cols, r], base - kx[cols, r + 1]
        dd, ldr = d[cols, r], ld[cols, r]
        ex, ey = torch.exp(-x.abs()), torch.exp(-y.abs())
        ll = m * (x.clamp(max=0.0) - torch.log1p(ex) - y.clamp(min=0.0)
                  - torch.log1p(ey) + ldr)
        invx, invy = 1.0 / (1.0 + ex), 1.0 / (1.0 + ey)
        sx = torch.where(x >= 0, invx, ex * invx)
        smx = torch.where(x >= 0, ex * invx, invx)
        sy = torch.where(y >= 0, invy, ey * invy)
        smy = torch.where(y >= 0, ey * invy, invy)
        dbase = m * (smx - sy)
        gx = m * smx / (smy * dd).clamp(min=1e-30)
        gy = m * sy / (sx * dd).clamp(min=1e-30)
        # threshold kappa_{t+1}: -gx from category t + 1, +gy from t
        dk = torch.stack([(torch.where(r == t + 1, -gx, 0.0)
                           + torch.where(r == t, gy, 0.0)).sum(0)
                          for t in range(cm1)], -1)
        return ll.sum(-1), dbase @ a, dbase.T @ theta, dk


def slot_table_floats(m: int, c: int) -> int:
    """Floats of the GRM kernel's per-call slot table: one (lo, hi, D,
    log D) slot for every category of every item of every
    ITEMS_PER_TILE-item tile (its prologue writes it where the kernel takes
    C at compile time, C <= 8 and K <= 8)."""
    return -(-m // ITEMS_PER_TILE) * c * ITEMS_PER_TILE * 4


def train_cuda(kernel, theta, a, kap, packed):
    """Launch one family's entry (csrc/loglik_grm.cu, loglik_gpcm.cu: the
    kernel of loglik_categorical.cuh) on theta (B, K)
    of any strides -> (ll (B,), dtheta (B, K), da (M, K), dkappa (M, C-1)),
    da and dkappa transposed views of the kernel's one (K + C - 1, M)
    output. The scratch holds the per-block and per-split partials of the
    plan (`one_pass.split_plan`) and, for GRM, the slot table its prologue
    writes (`slot_table_floats`)."""
    bsz, k = theta.shape
    m, cm1 = kap.shape
    f32 = dict(dtype=torch.float32, device=theta.device)
    plan = split_plan(bsz, m)
    tab = (torch.empty((slot_table_floats(m, cm1 + 1),), **f32)
           if kernel is TRAIN else None)
    ll = torch.empty((bsz,), **f32)
    dth = torch.empty((bsz, k), **f32)
    part_dth = torch.empty((plan.splits, bsz, k), **f32)
    part_llp = torch.empty((plan.splits, bsz), **f32)
    part = torch.empty((plan.blocks, k + cm1, m), **f32)
    grads = torch.empty((k + cm1, m), **f32)
    kernel(theta.data_ptr(), theta.stride(0), theta.stride(1), a.data_ptr(),
           kap.data_ptr(), None if tab is None else tab.data_ptr(),
           packed.data_ptr(), dth.data_ptr(), dth.stride(0),
           dth.stride(1), ll.data_ptr(), part_dth.data_ptr(),
           part_llp.data_ptr(), part.data_ptr(), grads.data_ptr(),
           bsz, m, k, cm1 + 1, *plan,
           torch.cuda.current_stream(theta.device).cuda_stream)
    return ll, dth, grads[:k].T, grads[k:].T


class _Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, a, kap, packed, family):
        kernel, plain = family
        if theta.is_cuda:
            ll, dth, da, dk = train_cuda(kernel, theta, a, kap, packed)
        else:
            ll, dth, da, dk = plain(theta, a, kap, packed)
        ctx.save_for_backward(dth, da, dk)
        return ll

    @staticmethod
    def backward(ctx, g):
        dth, da, dk = ctx.saved_tensors
        g0 = g.reshape(-1)[0]  # uniform-cotangent contract (module doc)
        return g[:, None] * dth, g0 * da, g0 * dk, None, None


def train_call(kernel, plain, theta, a, kap, packed):
    """Validate, cast theta, a and the table to f32, and run the one-pass
    op of the family (kernel, plain) -> (B,), or (S, B) when theta has a
    leading sample axis (a and kap per sample when a has one too, else
    shared)."""
    if packed.dtype != torch.int8 or packed.ndim != 2:
        raise ValueError(f"packed must be a (B, M) int8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    devices = {t.device for t in (theta, a, kap, packed)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    bsz, m = packed.shape
    batched = theta.ndim == 3
    per_sample = batched and a.ndim == 3
    lead = (theta.shape[0],) if per_sample else ()
    k = theta.shape[-1]
    cm1 = kap.shape[-1]
    if (theta.ndim not in (2, 3) or theta.shape[-2] != bsz
            or a.shape != lead + (m, k) or kap.shape != lead + (m, cm1)):
        raise ValueError(
            f"shapes theta {tuple(theta.shape)}, a {tuple(a.shape)}, kappa "
            f"{tuple(kap.shape)} do not match packed {tuple(packed.shape)}")
    if not MIN_C <= cm1 + 1 <= MAX_C:
        raise ValueError(f"the one-pass polytomous op takes {MIN_C} <= C <= "
                         f"{MAX_C} categories, got C={cm1 + 1}")
    theta, a, kap = theta.float(), a.float(), kap.float()
    if dev.type == "cuda":
        a, kap, packed = a.contiguous(), kap.contiguous(), packed.contiguous()
    family = (kernel, plain)
    if not batched:
        return _Train.apply(theta, a, kap, packed, family)
    return torch.stack([
        _Train.apply(theta[s], a[s] if per_sample else a,
                     kap[s] if per_sample else kap, packed, family)
        for s in range(theta.shape[0])])


def masked_loglik_grm_packed_train(theta: torch.Tensor, a: torch.Tensor,
                                   kappa: torch.Tensor, packed: torch.Tensor
                                   ) -> torch.Tensor:
    """One-pass graded (GRM) training loglik -> (B,) (or (S, B) with a
    leading sample axis): theta (B, K), a (M, K), kappa (M, C-1) ORDERED
    thresholds (`links.grm_thresholds`), packed (B, M) int8 code (0 =
    missing, 1 + category). Value-identical to
    `likelihood.graded_loglik_cells(...).sum(-1)` on the decoded data;
    gradients under the uniform-cotangent contract (module doc)."""
    return train_call(TRAIN, loglik_grm_train_plain, theta, a, kappa, packed)
