"""One-pass deep-link training loglik (counterpart of
`vibo_tpu.ops.pallas_deep`, same module name):

  masked_loglik_deep_packed_train   theta (B, K), d (M, D), the deep link's
                                    params, int8 code -> ll (B,)

The deep link scores every (student, item) pair with an MLP whose first
layer is split: pre1 = t1_i + t2_j with t1 = theta W_theta + b1 and t2 =
d W_item, h1 = relu(pre1), h2 = relu(h1 W2 + b2), logit = h2 . wo + bo. The
two small projections run here in f32; the pairwise part runs in ONE pass
over the code that emits the loglik and the sums every gradient needs:
s_theta = sum_j dpre1 (B, H), s_d = sum_i dpre1 (M, H), dW2, db2, dwo, dbo.
The backward finishes with small products: dtheta, dW_theta and db1 from
s_theta are exact for any per-person cotangent; dd, dW_item, dW2, db2, dwo
and dbo are scaled by the first cotangent (the UNIFORM-COTANGENT CONTRACT of
the Pallas op: use it only where the per-person logliks are summed into the
loss). A leading sample axis (theta (S, B, K)) runs one pass a sample, with
d per sample ((S, M, D)) or shared, on one shared code.

The pairwise products round their operands to bf16 and accumulate in f32
(h1 and W2 in the forward, h1 and dpre2 into dW2, dpre2 and W2 into dh1);
the relu masks use the f32 pre-activations. f32_dots=True keeps them in
f32 (the Pallas op's mode for HMC).

On a CUDA tensor the op runs csrc/deep_link.cu (`deep_link_train`, bf16
products; H = 128: one block a student tile holding W2 and dW2; H = 256,
384, 512: a thread-block cluster of 4, 8 or 16 blocks a student tile, W2
and dW2 split into column panels over it; every other width the kernel's
wide variant, with W2 read from L2), or with f32_dots
csrc/deep_link_f32.cu (`deep_link_f32_train`, any H % 128 == 0: at
H = 128, 256, 384 and 512 each product's operands split into three bf16
parts on the tensor cores, at f32 accuracy, at 256-512 on a thread-block
cluster of 4, 8 or 16 blocks a tile of 16 students; wider widths f32
products on the CUDA cores); on a
CPU tensor the plain PyTorch version `fused_deep_plain`, which repeats the
kernel's arithmetic over item blocks without ever holding a (B, M, H)
tensor. Nothing else falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vibo_tpu_torch._device import cast_through
from vibo_tpu_torch.ops import _build
from vibo_tpu_torch.ops._build import I, P
from vibo_tpu_torch.ops.packing import decode_packed

TRAIN = _build.register(_build.Kernel(
    "deep_link_train", "deep_link.cu", "deep_link_train",
    [P, P, P, P, P, P, P, P, P, I, I, I, I, P]))
TRAIN_F32 = _build.register(_build.Kernel(
    "deep_link_f32_train", "deep_link_f32.cu", "deep_link_f32_train",
    [P, P, P, P, P, P, P, P, P, I, I, I, I, P]))
_PLAN_ARGTYPES = [I, I, I, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_longlong)]
_PLAIN_BLOCK = 1 << 26      # (B, item block, H) elements of a plain block


def supports(link_params: dict) -> bool:
    """The fused op's precondition, as in JAX: the hidden width is a
    multiple of 128."""
    return link_params["w_theta"].shape[1] % 128 == 0


def fused_deep_plain(t1, t2, w2, b2, wo, bo, packed, f32_dots: bool = False,
                     item_block: int | None = None):
    """Plain version of the kernel: t1 (B, H), t2 (M, H), w2 (H, H), b2 (H),
    wo (H), bo (1), the code (B, M) -> (ll (B,), s_theta (B, H), s_d (M, H),
    dW2 (H, H), db2 (H), dwo (H), dbo (1)), the closed forms of the loglik's
    sum at the kernel's rounding points, over blocks of item_block items
    (default: about 2^26 pair activations a block)."""
    with torch.no_grad():
        cd = torch.float32 if f32_dots else torch.bfloat16
        bsz, h = t1.shape
        m = t2.shape[0]
        if item_block is None:
            item_block = max(1, _PLAIN_BLOCK // max(1, bsz * h))
        w2c = cast_through(w2, cd)
        mask, resp = decode_packed(packed)
        ll = t1.new_zeros((bsz,))
        sth = torch.zeros_like(t1)
        sd = t2.new_empty((m, h))
        dw2 = torch.zeros_like(w2)
        db2, dwo = torch.zeros_like(b2), torch.zeros_like(b2)
        dbo = torch.zeros_like(bo)
        for s in range(0, m, item_block):
            e = min(m, s + item_block)
            pre1 = t1[:, None, :] + t2[None, s:e, :]           # (B, ib, H)
            h1c = cast_through(pre1.clamp(min=0.0), cd)
            pre2 = h1c @ w2c + b2
            h2 = pre2.clamp(min=0.0)
            logit = (h2 * wo).sum(-1) + bo
            mk, r = mask[:, s:e], resp[:, s:e]
            ex = torch.exp(-logit.abs())
            sp = torch.log1p(ex) + logit.clamp(min=0.0)         # softplus
            ll += (-mk * torch.where(r > 0.5, sp - logit, sp)).sum(-1)
            inv = 1.0 / (1.0 + ex)
            dl = mk * (r - torch.where(logit >= 0, inv, 1.0 - inv))
            dwo += (h2 * dl[..., None]).sum((0, 1))
            dbo += dl.sum()
            dpre2 = torch.where(pre2 > 0, dl[..., None] * wo, 0.0)
            db2 += dpre2.sum((0, 1))
            dpc = cast_through(dpre2, cd)
            dw2 += h1c.reshape(-1, h).T @ dpc.reshape(-1, h)
            dpre1 = torch.where(pre1 > 0, dpc @ w2c.T, 0.0)
            sth += dpre1.sum(1)
            sd[s:e] = dpre1.sum(0)
        return ll, sth, sd, dw2, db2, dwo, dbo


@functools.lru_cache(maxsize=64)
def _plan(bsz: int, m: int, h: int, device_index: int,
          f32_dots: bool = False) -> tuple[int, int]:
    """(item splits, scratch floats) of csrc/deep_link.cu (or, f32_dots,
    csrc/deep_link_f32.cu) on the device."""
    kernel = TRAIN_F32 if f32_dots else TRAIN
    symbol = "deep_link_f32_plan" if f32_dots else "deep_link_plan"
    fn, lib = _build.bind(kernel.source, symbol, _PLAN_ARGTYPES)
    splits, floats = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        rc = fn(bsz, m, h, ctypes.byref(splits), ctypes.byref(floats))
    _build.check(rc, lib, symbol)
    return splits.value, floats.value


def train_cuda(t1, t2, w2, b2, wo, bo, packed, f32_dots: bool = False,
               recomputes: bool = False):
    """Launch csrc/deep_link.cu (f32_dots: csrc/deep_link_f32.cu, H a
    multiple of 128) on contiguous f32 inputs (wo (H,), bo (1,)) -> the
    seven outputs of fused_deep_plain, views of one buffer; with
    recomputes (f32_dots only) also the pre2 values the kernel recomputed
    in f64, a (1,) int32 tensor on the device (-1 where the width's kernel
    does not count them: every width but 256, 384 and 512)."""
    bsz, h = t1.shape
    m = t2.shape[0]
    if f32_dots and (h < 128 or h % 128):
        raise ValueError(f"the f32 deep-link kernel takes a link width that "
                         f"is a multiple of 128, got H={h}")
    dev = t1.device
    splits, floats = _plan(bsz, m, h, dev.index
                           if dev.index is not None
                           else torch.cuda.current_device(), f32_dots)
    if recomputes and not f32_dots:
        raise ValueError("only the f32 kernel counts its recomputes")
    sizes = (bsz, bsz * h, m * h, h * h, h, h, 1)
    # the f32 kernel's last word: its f64 recomputes (an int)
    out = torch.empty((sum(sizes) + f32_dots,), dtype=torch.float32,
                      device=dev)
    scratch = torch.empty((floats,), dtype=torch.float32, device=dev)
    kernel = TRAIN_F32 if f32_dots else TRAIN
    with torch.cuda.device(dev):
        kernel(t1.data_ptr(), t2.data_ptr(), w2.data_ptr(), b2.data_ptr(),
               wo.data_ptr(), bo.data_ptr(), packed.data_ptr(),
               out.data_ptr(), scratch.data_ptr(), bsz, m, h, splits,
               torch.cuda.current_stream(dev).cuda_stream)
    ll, sth, sd, dw2, db2, dwo, dbo = out[:sum(sizes)].split(sizes)
    outs = (ll, sth.view(bsz, h), sd.view(m, h), dw2.view(h, h), db2, dwo,
            dbo)
    if recomputes:
        return outs + (out[sum(sizes):].view(torch.int32),)
    return outs


class _Train(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, d, w_theta, w_item, b1, w2, b2, wo, bo, packed,
                f32_dots):
        t1 = theta @ w_theta + b1
        t2 = d @ w_item
        args = (t1, t2, w2, b2, wo.reshape(-1), bo.reshape(-1), packed)
        if theta.is_cuda:
            ll, sth, sd, *wgrads = train_cuda(*args, f32_dots=f32_dots)
        else:
            ll, sth, sd, *wgrads = fused_deep_plain(*args, f32_dots=f32_dots)
        ctx.save_for_backward(theta, d, w_theta, w_item, sth, sd, *wgrads)
        return ll

    @staticmethod
    def backward(ctx, g):
        theta, d, w_theta, w_item, sth, sd, dw2, db2, dwo, dbo = \
            ctx.saved_tensors
        gsth = g[:, None] * sth            # per person: any cotangent
        g0 = g.reshape(-1)[0]              # pooled: uniform contract
        return (gsth @ w_theta.T, g0 * (sd @ w_item.T), theta.T @ gsth,
                g0 * (d.T @ sd), gsth.sum(0), g0 * dw2, g0 * db2,
                (g0 * dwo).reshape(-1, 1), g0 * dbo, None, None)


def masked_loglik_deep_packed_train(theta: torch.Tensor, d: torch.Tensor,
                                    link_params: dict, packed: torch.Tensor,
                                    f32_dots: bool = False) -> torch.Tensor:
    """One-pass deep-link training loglik -> (B,) (or (S, B) with a leading
    sample axis on theta; d per sample when it has one too, else shared):
    theta (B, K), d (M, D), link_params {"w_theta" (K, H), "w_item" (D, H),
    "b1" (H,), "layer2": {"w" (H, H), "b" (H,)}, "out": {"w" (H, 1), "b"
    (1,)}}, packed (B, M) int8 code (0 = missing, 1 = wrong, 2 = right).
    Value == masked_loglik_per_person(apply_deep_link(...)) with the
    products' operands in bf16, or in f32 with f32_dots (module doc);
    gradients under the uniform-cotangent contract."""
    if packed.dtype != torch.int8 or packed.ndim != 2:
        raise ValueError(f"packed must be a (B, M) int8 tensor, got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    link = [link_params["w_theta"], link_params["w_item"], link_params["b1"],
            link_params["layer2"]["w"], link_params["layer2"]["b"],
            link_params["out"]["w"], link_params["out"]["b"]]
    devices = {t.device for t in (theta, d, packed, *link)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    bsz, m = packed.shape
    k, h = link[0].shape
    batched = theta.ndim == 3
    per_sample = batched and d.ndim == 3
    lead = (theta.shape[0],) if per_sample else ()
    if (theta.ndim not in (2, 3) or theta.shape[-2:] != (bsz, k)
            or d.shape != lead + (m, link[1].shape[0])
            or link[1].shape[1] != h or link[3].shape != (h, h)):
        raise ValueError(
            f"shapes theta {tuple(theta.shape)}, d {tuple(d.shape)}, "
            f"w_theta {tuple(link[0].shape)}, w_item {tuple(link[1].shape)} "
            f"do not match packed {tuple(packed.shape)}")
    theta, d = theta.float(), d.float()
    link = [t.float().contiguous() for t in link]
    packed = packed.contiguous()
    if not batched:
        return _Train.apply(theta, d, *link, packed, f32_dots)
    return torch.stack([
        _Train.apply(theta[s], d[s] if per_sample else d, *link, packed,
                     f32_dots)
        for s in range(theta.shape[0])])
