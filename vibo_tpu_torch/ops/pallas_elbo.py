"""Masked 2PL and 3PL Bernoulli log-likelihood ops (counterpart of
`vibo_tpu.ops.pallas_elbo`, same module name), each a
`torch.autograd.Function` with its Pallas op's custom-VJP contract:

  masked_loglik_2pl                 theta, a, b, resp, mask -> ll (B,)
  masked_loglik_2pl_packed          theta, a, b, int8 code  -> ll (B,)
  masked_loglik_2pl_packed_train_t  thetaT (K, B) -> scalar sum_i ll_i
  masked_loglik_2pl_packed_train    theta (B, K)  -> per-person ll (B,)

and the same four for 3PL (`masked_loglik_3pl`, `..._3pl_packed`,
`..._3pl_packed_train_t`, `..._3pl_packed_train`), which take the guess
logits g_hat (M,) after b: pi = g + (1 - g) sigmoid(l), g = sigmoid(g_hat),
computed in log space (csrc/irt_links.cuh) and differentiable in g_hat too.

The general ops (the first two of each link): the VJP is exact for any
per-person cotangent, and a leading sample axis (theta (S, B, K), with a,
b, g_hat and the data each per-sample or shared) runs as one launch. On a
CUDA tensor they run csrc/masked_loglik.cu, one source templated on the
link and on the cell reader (dense f32 resp/mask, or the int8 code).

The training ELBO on the code only consumes ll.sum(), so the train ops take
the value and all gradients from ONE pass over the code: the kernel emits
(ll, dtheta, da, db[, dg_hat]) and the backward only rescales them. On a
CUDA tensor both layouts run csrc/loglik_train.cu (theta addressed through
its strides, so no transpose is copied). The (B, K) train ops also take a
leading chain axis (the HMC potentials: theta (C, B, K)), one launch a
chain on the shared code.

On a CPU tensor each op runs the plain PyTorch version beside its kernel.
Nothing else falls back.
"""

from __future__ import annotations

import ctypes

import torch

from vibo_tpu_torch.ops import _build
from vibo_tpu_torch.ops._build import I, P
from vibo_tpu_torch.ops.one_pass import split_plan
from vibo_tpu_torch.ops.packing import decode_packed

L = ctypes.c_longlong

TRAIN = _build.register(_build.Kernel(
    "loglik_2pl_train", "loglik_train.cu", "loglik_2pl_train",
    [P, L, L, P, P, P, P, L, L, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
     P]))
TRAIN_3PL = _build.register(_build.Kernel(
    "loglik_3pl_train", "loglik_train.cu", "loglik_3pl_train",
    [P, L, L, P, P, P, P, P, L, L, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
     I, I, I, P]))
MASKED_FWD = _build.register(_build.Kernel(
    "masked_loglik_2pl_fwd", "masked_loglik.cu", "masked_loglik_2pl_fwd",
    [P, P, L, P, L, P, P, P, L, P, P, I, I, I, I, I, I, I, P]))
MASKED_BWD = _build.register(_build.Kernel(
    "masked_loglik_2pl_bwd", "masked_loglik.cu", "masked_loglik_2pl_bwd",
    [P, P, P, L, P, L, P, P, P, L, P, P, P, P, P, P, I, I, I, I, I, I, I,
     P]))
MASKED_FWD_3PL = _build.register(_build.Kernel(
    "masked_loglik_3pl_fwd", "masked_loglik.cu", "masked_loglik_3pl_fwd",
    [P, P, L, P, L, P, L, P, P, P, L, P, P, I, I, I, I, I, I, I, P]))
MASKED_BWD_3PL = _build.register(_build.Kernel(
    "masked_loglik_3pl_bwd", "masked_loglik.cu", "masked_loglik_3pl_bwd",
    [P, P, P, L, P, L, P, L, P, P, P, L, P, P, P, P, P, P, P, P, I, I, I, I,
     I, I, I, P]))


# ----------------------------------------------------- 3PL cell math


def _cells_3pl(logits, g_hat, resp, mask, grads: bool):
    """The 3PL cell of csrc/irt_links.cuh on dense logits (..., B, M), with
    g_hat (..., M): ll, and with grads also (dll/dl, dll/dg_hat), per cell.
    log g, log(1-g) and g are computed once per item, the branch ratios
    from t = exp(-|log g - log_s|) as 1/(1+t) (the larger) and t/(1+t)."""
    gh = g_hat[..., None, :]
    e_g = torch.exp(-gh.abs())
    lp_g = torch.log1p(e_g)
    log_g = -(lp_g + (-gh).clamp(min=0.0))
    log_1mg = -(lp_g + gh.clamp(min=0.0))
    e = torch.exp(-logits.abs())
    lp = torch.log1p(e)
    log_s = log_1mg - (lp - logits.clamp(max=0.0))
    log_1m_pi = log_1mg - (lp + logits.clamp(min=0.0))
    g_larger = log_g >= log_s
    hi = torch.where(g_larger, log_g, log_s)
    lo = torch.where(g_larger, log_s, log_g)
    t = torch.exp(lo - hi)
    ll = mask * (resp * (hi + torch.log1p(t)) + (1.0 - resp) * log_1m_pi)
    if not grads:
        return ll
    inv_g = 1.0 / (1.0 + e_g)
    g = torch.where(gh >= 0, inv_g, e_g * inv_g)
    inv = 1.0 / (1.0 + e)
    sg = torch.where(logits >= 0, inv, e * inv)          # sigmoid(l)
    om = torch.where(logits >= 0, e * inv, inv)          # 1 - sigmoid(l)
    big = 1.0 / (1.0 + t)
    small = t * big
    ratio_g = torch.where(g_larger, big, small)
    ratio_s = torch.where(g_larger, small, big)
    dl = mask * (resp * ratio_s * om - (1.0 - resp) * sg)
    dg = mask * (resp * ratio_g * (1.0 - g) * om - (1.0 - resp) * g)
    return ll, dl, dg


# ------------------------------------------- one-pass training loglik


def loglik_2pl_train_plain(theta, a, b, packed):
    """Plain version of the 2PL kernel: theta (B, K) -> (ll (B,), dtheta
    (B, K), da (M, K), db (M,)), dense logits and closed-form gradients of
    sum(ll)."""
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


def loglik_3pl_train_plain(theta, a, b, g_hat, packed):
    """Plain version of the 3PL kernel: theta (B, K) -> (ll (B,), dtheta
    (B, K), da (M, K), db (M,), dg_hat (M,)), gradients of sum(ll)."""
    with torch.no_grad():
        m, r = decode_packed(packed)
        ll, dl, dg = _cells_3pl(theta @ a.T - b, g_hat, r, m, grads=True)
        return ll.sum(-1), dl @ a, dl.T @ theta, -dl.sum(0), dg.sum(0)


def loglik_train_plain(theta, a, b, g_hat, packed):
    """The plain version of the link's kernel (g_hat None: 2PL) -> (ll,
    dtheta, *item gradients)."""
    if g_hat is None:
        return loglik_2pl_train_plain(theta, a, b, packed)
    return loglik_3pl_train_plain(theta, a, b, g_hat, packed)


def loglik_train_cuda(theta, a, b, g_hat, packed, dtheta, per_person: bool):
    """Launch csrc/loglik_train.cu (g_hat None: the 2PL kernel, else the
    3PL one) on theta (B, K) of any strides, writing dtheta (a (B, K) view
    of a preallocated buffer) through its strides. Returns (ll, item
    gradients): ll is (B,) if per_person else a scalar; the gradients are
    (da, db) or (da, db, dg_hat). The scratch holds the per-block and
    per-split partials of the plan (`one_pass.split_plan`)."""
    bsz, k = theta.shape
    m = a.shape[0]
    dev = theta.device
    plan = split_plan(bsz, m)
    nblk, nsplit = plan.blocks, plan.splits
    f32 = dict(dtype=torch.float32, device=dev)
    part_dth = torch.empty((nsplit, bsz, k), **f32)
    part_llp = torch.empty((nsplit, bsz), **f32) if per_person else None
    part_da = torch.empty((nblk, m, k), **f32)
    part_db = torch.empty((nblk, m), **f32)
    part_ll = torch.empty((nsplit, nblk), **f32)
    ll_person = torch.empty((bsz,), **f32) if per_person else None
    da = torch.empty((m, k), **f32)
    db = torch.empty((m,), **f32)
    ll = torch.empty((1,), **f32)
    head = (theta.data_ptr(), theta.stride(0), theta.stride(1), a.data_ptr(),
            b.data_ptr())
    mid = (packed.data_ptr(), dtheta.data_ptr(), dtheta.stride(0),
           dtheta.stride(1),
           None if ll_person is None else ll_person.data_ptr(),
           part_dth.data_ptr(),
           None if part_llp is None else part_llp.data_ptr(),
           part_da.data_ptr(), part_db.data_ptr())
    tail = (bsz, m, k, *plan, torch.cuda.current_stream(dev).cuda_stream)
    # the launch counted by the op it serves: "kb" the scalar op on theta
    # (K, B) (rows 3 and 10), "bk" the per-person op on theta (B, K) (rows
    # 4 and 9); one device kernel for both
    variant = "bk" if per_person else "kb"
    if g_hat is None:
        TRAIN(*head, *mid, part_ll.data_ptr(), da.data_ptr(), db.data_ptr(),
              ll.data_ptr(), *tail, variant=variant)
        grads = (da, db)
    else:
        part_dg = torch.empty((nblk, m), **f32)
        dg = torch.empty((m,), **f32)
        TRAIN_3PL(*head, g_hat.data_ptr(), *mid, part_dg.data_ptr(),
                  part_ll.data_ptr(), da.data_ptr(), db.data_ptr(),
                  dg.data_ptr(), ll.data_ptr(), *tail, variant=variant)
        grads = (da, db, dg)
    return (ll_person if per_person else ll[0]), grads


def _no_g_hat_grad(grads: tuple) -> tuple:
    """The backward's item gradients in input order: (da, db, dg_hat), with
    None for g_hat under 2PL."""
    return grads if len(grads) == 3 else (*grads, None)


class _TrainT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, thetaT, a, b, g_hat, packed):
        if thetaT.is_cuda:
            dthT = torch.empty(thetaT.shape, dtype=torch.float32,
                               device=thetaT.device)
            ll, grads = loglik_train_cuda(thetaT.T, a, b, g_hat, packed,
                                          dthT.T, per_person=False)
        else:
            ll, dth, *grads = loglik_train_plain(thetaT.T, a, b, g_hat,
                                                 packed)
            ll, dthT = ll.sum(), dth.T
        ctx.save_for_backward(dthT, *grads)
        return ll

    @staticmethod
    def backward(ctx, g):
        dthT, *grads = ctx.saved_tensors
        return (g * dthT, *_no_g_hat_grad(tuple(g * x for x in grads)),
                None)


class _Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, a, b, g_hat, packed):
        if theta.is_cuda:
            dth = torch.empty(theta.shape, dtype=torch.float32,
                              device=theta.device)
            ll, grads = loglik_train_cuda(theta, a, b, g_hat, packed, dth,
                                          per_person=True)
        else:
            ll, dth, *grads = loglik_train_plain(theta, a, b, g_hat, packed)
        ctx.save_for_backward(dth, *grads)
        return ll

    @staticmethod
    def backward(ctx, g):
        dth, *grads = ctx.saved_tensors
        g0 = g.reshape(-1)[0]  # uniform-cotangent contract (module doc)
        return (g[:, None] * dth, *_no_g_hat_grad(tuple(g0 * x
                                                        for x in grads)),
                None)


def _prepare(theta, a, b, g_hat, packed, k_axis: int):
    """Validate and cast: f32 theta/a/b/g_hat, int8 code, one device, K
    bound."""
    if packed.dtype != torch.int8 or packed.ndim != 2:
        raise ValueError(f"packed must be a (B, M) int8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    items = (a, b) if g_hat is None else (a, b, g_hat)
    devices = {t.device for t in (theta, *items, packed)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    bsz, m = packed.shape
    k = theta.shape[k_axis]
    if (theta.ndim != 2 or theta.shape[1 - k_axis] != bsz
            or a.shape != (m, k) or b.shape != (m,)
            or (g_hat is not None and g_hat.shape != (m,))):
        raise ValueError(
            f"shapes theta {tuple(theta.shape)}, a {tuple(a.shape)}, b "
            f"{tuple(b.shape)}"
            + ("" if g_hat is None else f", g_hat {tuple(g_hat.shape)}")
            + f" do not match packed {tuple(packed.shape)}")
    theta = theta.float()
    items = [x.float() for x in items]
    if packed.is_cuda:
        items = [x.contiguous() for x in items]
        packed = packed.contiguous()
    elif packed.device.type != "cpu":
        raise ValueError(f"no kernel for device {packed.device}")
    if g_hat is None:
        items.append(None)
    return theta, *items, packed


def masked_loglik_2pl_packed_train_t(thetaT: torch.Tensor, a: torch.Tensor,
                                     b: torch.Tensor, packed: torch.Tensor
                                     ) -> torch.Tensor:
    """Transposed-theta one-pass 2PL training loglik: thetaT (K, B) ->
    SCALAR sum_i ll_i. The scalar output makes the uniform-cotangent contract
    exact by construction: the backward scales (dthetaT, da, db) by g."""
    return _TrainT.apply(*_prepare(thetaT, a, b, None, packed, k_axis=0))


class _TrainChains(torch.autograd.Function):
    """The (B, K) op over a leading chain axis: theta (C, B, K), each item
    parameter per chain ((C, M, K), (C, M)) or shared ((M, K), (M,)), one
    launch a chain on the shared code (its dtheta written into a slice of
    one (C, B, K) buffer). The backward is the single-chain one, chain by
    chain: dtheta exact for any cotangent, the item gradients scaled by
    each chain's first cotangent and summed over the chains where shared.
    One autograd node for all chains."""

    @staticmethod
    def forward(ctx, theta, a, b, g_hat, packed):
        chains = theta.shape[0]

        def chain(x, c, lead_ndim):
            return x if x is None or x.ndim == lead_ndim else x[c]
        dth = (torch.empty(theta.shape, dtype=torch.float32,
                           device=theta.device) if theta.is_cuda else None)
        lls, dths, grads = [], [], []
        for c in range(chains):
            args = _prepare(theta[c], chain(a, c, 2), chain(b, c, 1),
                            chain(g_hat, c, 1), packed, k_axis=1)
            if theta.is_cuda:
                ll, gr = loglik_train_cuda(*args, dth[c], per_person=True)
            else:
                ll, dth_c, *gr = loglik_train_plain(*args)
                dths.append(dth_c)
            lls.append(ll)
            grads.append(gr)
        if dth is None:
            dth = torch.stack(dths)
        items = [torch.stack(g) for g in zip(*grads)]
        ctx.shared = [x is not None and x.ndim == nd for x, nd in
                      ((a, 2), (b, 1), (g_hat, 1))][:len(items)]
        ctx.save_for_backward(dth, *items)
        return torch.stack(lls)

    @staticmethod
    def backward(ctx, g):
        dth, *items = ctx.saved_tensors
        g0 = g[:, 0]                    # each chain's first cotangent
        out = []
        for x, shared in zip(items, ctx.shared):
            gx = g0.reshape((-1,) + (1,) * (x.ndim - 1)) * x
            out.append(gx.sum(0) if shared else gx)
        return (g[..., None] * dth, *_no_g_hat_grad(tuple(out)), None)


def _train_chains(theta, a, b, g_hat, packed) -> torch.Tensor:
    """The (B, K) one-pass op -> (B,), or (C, B) with a leading chain axis
    on theta (C, B, K) (_TrainChains)."""
    if theta.ndim != 3:
        return _Train.apply(*_prepare(theta, a, b, g_hat, packed, k_axis=1))
    return _TrainChains.apply(theta, a, b, g_hat, packed)


def masked_loglik_2pl_packed_train(theta: torch.Tensor, a: torch.Tensor,
                                   b: torch.Tensor, packed: torch.Tensor
                                   ) -> torch.Tensor:
    """One-pass training variant of the masked 2PL loglik -> (B,), or
    (C, B) with a leading chain axis (theta (C, B, K), a (C, M, K) or
    shared (M, K), b (C, M) or shared (M,); one launch a chain, the code
    shared).

    Value-identical to the general op; gradients are precomputed in the same
    kernel pass under the UNIFORM-COTANGENT CONTRACT: the caller must only
    use this where every person's loglik gets the same weight (e.g. followed
    by .sum() into a scalar loss, as in elbo_packed_sums), per chain.
    dtheta is exact for any cotangent; da/db assume uniformity."""
    return _train_chains(theta, a, b, None, packed)


def masked_loglik_3pl_packed_train_t(thetaT: torch.Tensor, a: torch.Tensor,
                                     b: torch.Tensor, g_hat: torch.Tensor,
                                     packed: torch.Tensor) -> torch.Tensor:
    """Transposed-theta one-pass 3PL training loglik: thetaT (K, B) ->
    SCALAR sum_i ll_i (see masked_loglik_2pl_packed_train_t); the backward
    scales (dthetaT, da, db, dg_hat) by g."""
    return _TrainT.apply(*_prepare(thetaT, a, b, g_hat, packed, k_axis=0))


def masked_loglik_3pl_packed_train(theta: torch.Tensor, a: torch.Tensor,
                                   b: torch.Tensor, g_hat: torch.Tensor,
                                   packed: torch.Tensor) -> torch.Tensor:
    """One-pass 3PL training variant -> (B,) (or (C, B) with a leading
    chain axis, g_hat (C, M) or shared, as masked_loglik_2pl_packed_train),
    under its uniform-cotangent contract: dtheta is exact for any
    cotangent; da, db and dg_hat assume uniformity."""
    return _train_chains(theta, a, b, g_hat, packed)


# ----------------------------------------- general masked 2PL/3PL loglik
#
# Internally every array carries a leading sample axis: theta (S, B, K),
# a (Sa, M, K), b (Sb, M), g_hat (Sg, M), resp/mask/packed (Sd, B, M), each
# of Sa, Sb, Sg, Sd either S or 1 (shared over the samples).


def masked_loglik_2pl_plain(theta, a, b, resp, mask):
    """Plain version of the 2PL forward kernel -> ll (S, B): dense logits
    and the closed form m * (r*l - softplus(l)), softplus in its stable
    form."""
    with torch.no_grad():
        logits = theta @ a.transpose(-1, -2) - b[:, None, :]
        sp = torch.log1p(torch.exp(-logits.abs()))
        return (mask * ((resp * logits - logits.clamp(min=0.0)) - sp)).sum(-1)


def _sum_shared(grad, x, s: int):
    """A gradient of x summed over the samples when x is shared over them."""
    return grad.sum(0, keepdim=True) if x.shape[0] < s else grad


def masked_loglik_2pl_vjp_plain(g, theta, a, b, resp, mask):
    """Plain version of the 2PL backward kernel: the VJP of
    masked_loglik_2pl_plain for the cotangent g (S, B) -> (dtheta (S, B, K),
    da (Sa, M, K), db (Sb, M)); a shared a or b sums over the samples."""
    with torch.no_grad():
        logits = theta @ a.transpose(-1, -2) - b[:, None, :]
        dl = g[..., None] * (mask * (resp - torch.sigmoid(logits)))
        s = theta.shape[0]
        return (dl @ a, _sum_shared(dl.transpose(-1, -2) @ theta, a, s),
                _sum_shared(-dl.sum(-2), b, s))


def masked_loglik_3pl_plain(theta, a, b, g_hat, resp, mask):
    """Plain version of the 3PL forward kernel -> ll (S, B): dense logits
    and the log-space closed forms of csrc/irt_links.cuh."""
    with torch.no_grad():
        logits = theta @ a.transpose(-1, -2) - b[:, None, :]
        return _cells_3pl(logits, g_hat, resp, mask, grads=False).sum(-1)


def masked_loglik_3pl_vjp_plain(g, theta, a, b, g_hat, resp, mask):
    """Plain version of the 3PL backward kernel: the VJP of
    masked_loglik_3pl_plain for the cotangent g (S, B) -> (dtheta, da, db,
    dg_hat (Sg, M)); a shared a, b or g_hat sums over the samples."""
    with torch.no_grad():
        logits = theta @ a.transpose(-1, -2) - b[:, None, :]
        _, dl, dgc = _cells_3pl(logits, g_hat, resp, mask, grads=True)
        dl = g[..., None] * dl
        s = theta.shape[0]
        return (dl @ a, _sum_shared(dl.transpose(-1, -2) @ theta, a, s),
                _sum_shared(-dl.sum(-2), b, s),
                _sum_shared((g[..., None] * dgc).sum(-2), g_hat, s))


def masked_plain(theta, a, b, g_hat, resp, mask):
    """The link's plain forward (g_hat None: 2PL)."""
    if g_hat is None:
        return masked_loglik_2pl_plain(theta, a, b, resp, mask)
    return masked_loglik_3pl_plain(theta, a, b, g_hat, resp, mask)


def masked_vjp_plain(g, theta, a, b, g_hat, resp, mask):
    """The link's plain VJP (g_hat None: 2PL) -> (dtheta, da, db[, dg])."""
    if g_hat is None:
        return masked_loglik_2pl_vjp_plain(g, theta, a, b, resp, mask)
    return masked_loglik_3pl_vjp_plain(g, theta, a, b, g_hat, resp, mask)


def _sample_stride(x, s: int) -> int:
    """Elements between two samples of x, 0 when x is shared over them."""
    return 0 if x.shape[0] == 1 and s > 1 else x[0].numel()


def _data_args(resp, mask, packed):
    """(resp, mask, packed) pointers for the kernel's cell reader, its
    sample stride and the reader's name."""
    if packed is not None:
        return None, None, packed.data_ptr(), packed, "int8"
    return resp.data_ptr(), mask.data_ptr(), None, resp, "dense"


def _item_args(a, b, g_hat, s: int) -> tuple:
    """(a, a_ss, b, b_ss[, g_hat, g_ss]): item pointers and sample strides,
    g_hat's only for 3PL."""
    out = (a.data_ptr(), _sample_stride(a, s), b.data_ptr(),
           _sample_stride(b, s))
    if g_hat is None:
        return out
    return out + (g_hat.data_ptr(), _sample_stride(g_hat, s))


def masked_fwd_cuda(theta, a, b, g_hat, resp, mask, packed):
    """Launch the link's forward kernels (g_hat None: 2PL): ll (S, B). Pass
    (resp, mask) with packed None for the dense reader, or packed with resp
    and mask None. The scratch holds the per-split ll of the plan
    (`one_pass.split_plan` over the S samples)."""
    s, bsz, k = theta.shape
    m = a.shape[1]
    f32 = dict(dtype=torch.float32, device=theta.device)
    plan = split_plan(bsz, m, samples=s)
    part_ll = torch.empty((plan.splits, s, bsz), **f32)
    ll = torch.empty((s, bsz), **f32)
    rp, mp, pp, data, reader = _data_args(resp, mask, packed)
    kernel = MASKED_FWD if g_hat is None else MASKED_FWD_3PL
    kernel(theta.data_ptr(), *_item_args(a, b, g_hat, s), rp, mp, pp,
           _sample_stride(data, s), part_ll.data_ptr(), ll.data_ptr(), s,
           bsz, m, k, *plan,
           torch.cuda.current_stream(theta.device).cuda_stream,
           variant=reader)
    return ll


def masked_bwd_cuda(g, theta, a, b, g_hat, resp, mask, packed):
    """Launch the link's backward kernels for the cotangent g (S, B):
    (dtheta (S, B, K), da (Sa, M, K), db (Sb, M)[, dg_hat (Sg, M)]). The
    scratch holds the per-split dtheta and the per-block item partials of
    the plan (`one_pass.split_plan` over the S samples)."""
    s, bsz, k = theta.shape
    m = a.shape[1]
    dev = theta.device
    f32 = dict(dtype=torch.float32, device=dev)
    plan = split_plan(bsz, m, samples=s)
    nblk = plan.blocks
    dtheta = torch.empty((s, bsz, k), **f32)
    part_dth = torch.empty((plan.splits, s, bsz, k), **f32)
    part_da = torch.empty((nblk, s, m, k), **f32)
    part_db = torch.empty((nblk, s, m), **f32)
    da = torch.empty(a.shape, **f32)
    db = torch.empty(b.shape, **f32)
    rp, mp, pp, data, reader = _data_args(resp, mask, packed)
    head = (g.data_ptr(), theta.data_ptr(), *_item_args(a, b, g_hat, s), rp,
            mp, pp, _sample_stride(data, s), dtheta.data_ptr(),
            part_dth.data_ptr(), part_da.data_ptr(), part_db.data_ptr())
    tail = (s, bsz, m, k, *plan, torch.cuda.current_stream(dev).cuda_stream)
    if g_hat is None:
        MASKED_BWD(*head, da.data_ptr(), db.data_ptr(), *tail,
                   variant=reader)
        return dtheta, da, db
    part_dg = torch.empty((nblk, s, m), **f32)
    dg = torch.empty(g_hat.shape, **f32)
    MASKED_BWD_3PL(*head, part_dg.data_ptr(), da.data_ptr(), db.data_ptr(),
                   dg.data_ptr(), *tail, variant=reader)
    return dtheta, da, db, dg


class _Masked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, a, b, g_hat, resp, mask, packed):
        ctx.save_for_backward(theta, a, b, g_hat, resp, mask, packed)
        if theta.is_cuda:
            return masked_fwd_cuda(theta, a, b, g_hat, resp, mask, packed)
        if packed is not None:
            mask, resp = decode_packed(packed)
        return masked_plain(theta, a, b, g_hat, resp, mask)

    @staticmethod
    def backward(ctx, g):
        theta, a, b, g_hat, resp, mask, packed = ctx.saved_tensors
        if theta.is_cuda:
            grads = masked_bwd_cuda(g.contiguous(), theta, a, b, g_hat, resp,
                                    mask, packed)
        else:
            if packed is not None:
                mask, resp = decode_packed(packed)
            grads = masked_vjp_plain(g, theta, a, b, g_hat, resp, mask)
        return (grads[0], *_no_g_hat_grad(grads[1:]), None, None, None)


def _lift(x, ndim: int, name: str):
    """x with a leading sample axis of 1 added when it has ndim - 1 dims."""
    if x.ndim == ndim - 1:
        return x.unsqueeze(0)
    if x.ndim != ndim:
        raise ValueError(f"{name} must have {ndim - 1} or {ndim} dims, got "
                         f"shape {tuple(x.shape)}")
    return x


def _masked_call(theta, a, b, g_hat, resp, mask, packed):
    """Validate, cast to f32, give every array a sample axis, run _Masked
    and drop the axis again when theta had none. g_hat None: 2PL."""
    data = [x for x in (resp, mask, packed) if x is not None]
    items = [x for x in (a, b, g_hat) if x is not None]
    devices = {t.device for t in (theta, *items, *data)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    batched = theta.ndim == 3
    theta = _lift(theta.float(), 3, "theta")
    a, b = _lift(a.float(), 3, "a"), _lift(b.float(), 2, "b")
    items = [a, b]
    if g_hat is not None:
        g_hat = _lift(g_hat.float(), 2, "g_hat")
        items.append(g_hat)
    if packed is None:
        resp, mask = _lift(resp.float(), 3, "resp"), _lift(mask.float(), 3,
                                                            "mask")
        data = [resp, mask]
    else:
        data = [_lift(packed, 3, "packed")]
    s, bsz, k = theta.shape
    m = a.shape[1]
    ok = (a.shape[1:] == (m, k)
          and all(x.shape[1:] == (m,) for x in items[1:])
          and all(x.shape[1:] == (bsz, m) for x in data)
          and all(x.shape[0] in (1, s) for x in (*items, *data)))
    if not ok:
        raise ValueError(
            f"shapes theta {tuple(theta.shape)}, items "
            f"{[tuple(x.shape) for x in items]}, data "
            f"{[tuple(x.shape) for x in data]} do not match (leading sample "
            "axes must equal theta's or be absent)")
    if dev.type == "cuda":
        theta = theta.contiguous()
        items = [x.contiguous() for x in items]
        data = [x.contiguous() for x in data]
    a, b = items[:2]
    g_hat = items[2] if g_hat is not None else None
    if packed is None:
        ll = _Masked.apply(theta, a, b, g_hat, data[0], data[1], None)
    else:
        ll = _Masked.apply(theta, a, b, g_hat, None, None, data[0])
    return ll if batched else ll[0]


def _check_code(packed):
    if packed.dtype != torch.int8:
        raise ValueError(f"packed must be an int8 tensor, got {packed.dtype}")
    return packed


def masked_loglik_2pl(theta: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      resp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-person masked 2PL Bernoulli log-likelihood.

    theta (B, K), a (M, K), b (M,), resp/mask (B, M) -> (B,); with a leading
    sample axis theta (S, B, K) -> (S, B), and a (S, M, K), b (S, M),
    resp/mask (S, B, M) each per-sample or without the axis (shared).
    Semantics == likelihood.masked_loglik_per_person(links.logits_2pl(...)).
    Differentiable in theta, a and b, exact for any cotangent. theta, a, b,
    resp and mask are cast to f32, as the JAX op casts them."""
    return _masked_call(theta, a, b, None, resp, mask, None)


def masked_loglik_2pl_packed(theta: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, packed: torch.Tensor
                             ) -> torch.Tensor:
    """masked_loglik_2pl on the int8 code (packing.pack_responses) instead
    of (resp, mask): same values and gradients, 1 byte a cell instead of 8."""
    return _masked_call(theta, a, b, None, None, None, _check_code(packed))


def masked_loglik_3pl(theta: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      g_hat: torch.Tensor, resp: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Per-person masked 3PL Bernoulli log-likelihood -> (B,), or (S, B)
    with a leading sample axis (g_hat (M,) or (S, M), like b).

    Semantics == likelihood.masked_loglik_per_person(links.logits_3pl(...),
    g_hat=g_hat). Differentiable in theta, a, b and g_hat, exact for any
    cotangent; all inputs are cast to f32, as the JAX op casts them."""
    return _masked_call(theta, a, b, g_hat, resp, mask, None)


def masked_loglik_3pl_packed(theta: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor, g_hat: torch.Tensor,
                             packed: torch.Tensor) -> torch.Tensor:
    """masked_loglik_3pl on the int8 code instead of (resp, mask)."""
    return _masked_call(theta, a, b, g_hat, None, None, _check_code(packed))
