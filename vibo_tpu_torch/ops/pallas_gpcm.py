"""One-pass partial-credit (GPCM) training loglik (counterpart of
`vibo_tpu.ops.pallas_gpcm`, same module name):

  masked_loglik_gpcm_packed_train  theta (B, K), a (M, K), kap (M, C-1)
                                   cumulative step sums, int8 code -> (B,)

The same one-pass contract as `pallas_grm` (whose machinery it shares):
the value and every gradient from one pass over the code, dtheta exact
for any per-person cotangent, da and dkap scaled by the first cotangent,
the step sums reparameterized outside the op (`links.gpcm_cumsteps`), a
leading sample axis one launch a sample. On a CUDA tensor the op runs
csrc/loglik_gpcm.cu (`loglik_gpcm_train`) at every C in [3, 32]
(the JAX op sends C > 16 to its XLA twin; the kernel takes C <= 8 as a
compile-time value, its exponentials and dkap sums in registers, and any
larger C at run time); on a CPU tensor the plain PyTorch version beside
it.
"""

from __future__ import annotations

import torch

from vibo_tpu_torch.ops import _build
from vibo_tpu_torch.ops.pallas_grm import ARGTYPES, decode_categories, train_call

TRAIN = _build.register(_build.Kernel(
    "loglik_gpcm_train", "loglik_gpcm.cu", "loglik_gpcm_train",
    ARGTYPES))


def loglik_gpcm_train_plain(theta, a, kap, packed):
    """Plain version of the kernel: theta (B, K) -> (ll (B,), dtheta (B, K),
    da (M, K), dkap (M, C-1)): z_c = c base - kap_c (z_0 = 0), the softmax
    with its largest z subtracted, and the closed-form gradients of sum(ll),
    dbase = r - E[c] and dkap_c = p_c - [r = c]."""
    with torch.no_grad():
        cm1 = kap.shape[-1]
        m, r = decode_categories(packed, cm1 + 1)
        base = theta @ a.T
        zs = [c * base - kap[:, c - 1] for c in range(1, cm1 + 1)]
        mx = torch.zeros_like(base)
        zr = torch.zeros_like(base)
        for c, z in enumerate(zs, start=1):
            mx = torch.maximum(mx, z)
            zr = torch.where(r == c, z, zr)
        es = [torch.exp(z - mx) for z in zs]
        s = torch.exp(-mx)
        ec = torch.zeros_like(base)
        for c, e in enumerate(es, start=1):
            s = s + e
            ec = ec + c * e
        inv = 1.0 / s
        ll = m * (zr - mx - torch.log(s))
        dbase = m * (r - ec * inv)
        dk = torch.stack([(m * (e * inv - (r == c).float())).sum(0)
                          for c, e in enumerate(es, start=1)], -1)
        return ll.sum(-1), dbase @ a, dbase.T @ theta, dk


def masked_loglik_gpcm_packed_train(theta: torch.Tensor, a: torch.Tensor,
                                    kap: torch.Tensor, packed: torch.Tensor
                                    ) -> torch.Tensor:
    """One-pass partial-credit (GPCM) training loglik -> (B,) (or (S, B)
    with a leading sample axis): theta (B, K), a (M, K), kap (M, C-1)
    CUMULATIVE STEP SUMS (`links.gpcm_cumsteps`), packed (B, M) int8 code.
    Value-identical to `likelihood.gpcm_loglik_cells(...).sum(-1)` on the
    decoded data; gradients under the uniform-cotangent contract."""
    return train_call(TRAIN, loglik_gpcm_train_plain, theta, a, kap, packed)
