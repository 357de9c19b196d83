"""Gaussian building blocks (counterpart of `vibo_tpu.ops.distributions`).
Scale is carried as logvar.

The `tril_*` family is the full-covariance Gaussian through a Cholesky
factor L: diag(L) = exp(0.5 * logvar), the strict lower triangle `off`
((..., K(K-1)/2), row-major pairs (1,0),(2,0),(2,1),...). `off=None` (or
width 0) gives the diagonal family bitwise. Its densities stay closed form:

  z      = mu + L eps,            eps ~ N(0, I)
  KL     = diag-KL + 0.5 * ||off||^2
  log q(z) at z = mu + L eps
         = -0.5 * (K log 2pi + sum(logvar) + ||eps||^2)      (no solve)

Everything is unrolled over K (small) as in JAX: no torch.linalg. The
floors of JAX's `jnp.maximum(x, 1e-12)` / `jnp.clip(x, 1e-12, None)` are
`torch.maximum` against a tensor, which, like JAX, halves the gradient
at a tie (torch.clamp_min passes all of it)."""

from __future__ import annotations

import torch

LOG2PI = 1.8378770664093453  # log(2*pi)


def floor_at(x, value: float):
    """jnp.maximum(x, value): the gradient split in half at a tie."""
    return torch.maximum(x, torch.full((), value, dtype=x.dtype,
                                       device=x.device))


def reparameterize_eps(eps, mu, logvar):
    """z = mu + sigma * eps with exogenous noise eps."""
    return mu + torch.exp(0.5 * logvar) * eps


def reparameterize(mu, logvar, generator: torch.Generator | None = None):
    """z = mu + sigma * eps with eps drawn from `generator`."""
    eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return reparameterize_eps(eps, mu, logvar)


def kl_standard_normal(mu, logvar):
    """Elementwise KL(N(mu, exp(logvar)) || N(0, 1))."""
    return 0.5 * (torch.square(mu) + torch.exp(logvar) - logvar - 1.0)


def gaussian_log_prob(z, mu, logvar):
    """Elementwise log N(z; mu, exp(logvar))."""
    return -0.5 * (LOG2PI + logvar + torch.square(z - mu) * torch.exp(-logvar))


def standard_normal_log_prob(z):
    """Elementwise log N(z; 0, 1)."""
    return -0.5 * (LOG2PI + torch.square(z))


# ------------------------------------------- full-covariance (Cholesky) q


def tril_dim(k: int) -> int:
    """Number of strictly-lower-triangular entries of a (k, k) matrix."""
    return (k * (k - 1)) // 2


def _has_off(off) -> bool:
    return off is not None and off.shape[-1] > 0


def tril_reparameterize_eps(eps, mu, logvar, off=None):
    """z = mu + L eps: eps/mu/logvar (..., K), off (..., K(K-1)/2) or None
    (the diagonal family, bitwise reparameterize_eps). The strict-lower
    mixing is K-1 small multiply-adds, unrolled."""
    z = reparameterize_eps(eps, mu, logvar)
    if not _has_off(off):
        return z
    k = mu.shape[-1]
    if off.shape[-1] != tril_dim(k):
        raise ValueError(
            f"off has {off.shape[-1]} entries; K={k} needs {tril_dim(k)}")
    parts = [torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)]
    idx = 0
    for i in range(1, k):
        parts.append((off[..., idx:idx + i] * eps[..., :i]).sum(-1))
        idx += i
    return z + torch.stack(parts, dim=-1)


def tril_reparameterize(mu, logvar, off=None,
                        generator: torch.Generator | None = None):
    """tril_reparameterize_eps with eps drawn from `generator`. Returns
    (z, eps): tril_log_prob_from_eps needs the noise."""
    eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    return tril_reparameterize_eps(eps, mu, logvar, off), eps


def kl_standard_normal_tril(mu, logvar, off=None):
    """Per-person KL(N(mu, L L^T) || N(0, I)), last axis reduced: the
    diagonal KL + 0.5 ||off||^2."""
    kl = kl_standard_normal(mu, logvar).sum(-1)
    if _has_off(off):
        kl = kl + 0.5 * torch.square(off).sum(-1)
    return kl


def tril_log_prob_from_eps(eps, logvar):
    """Per-person log N(z; mu, L L^T) at z = mu + L eps (L^-1 (z - mu) is
    eps, so no solve; off does not enter)."""
    k = eps.shape[-1]
    return -0.5 * (k * LOG2PI + logvar.sum(-1) + torch.square(eps).sum(-1))


def tril_marginal_sigma(logvar, off=None):
    """Per-dimension marginal sds (..., K): the row norms of L. off=None
    gives exp(0.5 * logvar)."""
    var = torch.exp(logvar)
    if not _has_off(off):
        return torch.sqrt(var)
    k = logvar.shape[-1]
    parts = [torch.zeros(var.shape[:-1], dtype=var.dtype, device=var.device)]
    idx = 0
    for i in range(1, k):
        parts.append(torch.square(off[..., idx:idx + i]).sum(-1))
        idx += i
    return torch.sqrt(var + torch.stack(parts, dim=-1))


def triu_flat_index(k: int):
    """Pairs of the upper triangle with its diagonal in row-major order,
    (0,0),(0,1),..,(0,K-1),(1,1),..: the order of the Fisher pair
    statistics (np.triu_indices)."""
    return [(i, j) for i in range(k) for j in range(i, k)]


def laplace_anchor_parts(c, s_flat):
    """(logvar, off) of the Laplace-anchored posterior's Cholesky factor:
    cov_i = (I_K + D_i S_i D_i)^-1, D_i = diag(exp(0.5 c_i)), with S_i the
    per-person pair statistic s_flat (..., K(K+1)/2) in triu_flat_index
    order and c (..., K) the head's per-dim log correction. Unrolled as in
    JAX: chol(info), its inverse by forward substitution, cov = W^T W and
    chol(cov). K = 1 returns (logvar, None)."""
    k = c.shape[-1]
    idx = {p: n for n, p in enumerate(triu_flat_index(k))}
    d = [torch.exp(0.5 * c[..., i]) for i in range(k)]
    info = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            v = d[i] * d[j] * s_flat[..., idx[(i, j)]]
            if i == j:
                v = v + 1.0
            info[i][j] = info[j][i] = v
    r = _chol(info, k)
    if k == 1:
        return (-2.0 * torch.log(r[0][0]))[..., None], None
    w = [[None] * k for _ in range(k)]
    for j in range(k):
        w[j][j] = 1.0 / r[j][j]
        for i in range(j + 1, k):
            acc = r[i][j] * w[j][j]
            for p in range(j + 1, i):
                acc = acc + r[i][p] * w[p][j]
            w[i][j] = -acc / r[i][i]
    cov = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i, k):
            acc = 0.0
            for p in range(max(i, j), k):
                acc = acc + w[p][i] * w[p][j]
            cov[i][j] = cov[j][i] = acc
    el = _chol(cov, k)
    logvar = torch.stack([2.0 * torch.log(el[i][i]) for i in range(k)], -1)
    off = torch.stack([el[i][p] for i in range(1, k) for p in range(i)], -1)
    return logvar, off


def _chol(a, k: int):
    """Lower Cholesky factor of a symmetric (K, K) nest of tensors
    (Cholesky-Banachiewicz, unrolled; the diagonal floored at 1e-12)."""
    r = [[None] * k for _ in range(k)]
    for j in range(k):
        acc = a[j][j]
        for p in range(j):
            acc = acc - torch.square(r[j][p])
        r[j][j] = torch.sqrt(floor_at(acc, 1e-12))
        for i in range(j + 1, k):
            acc = a[i][j]
            for p in range(j):
                acc = acc - r[i][p] * r[j][p]
            r[i][j] = acc / r[j][j]
    return r


def tril_matrix(logvar, off=None):
    """The (..., K, K) Cholesky factor L (frame transport of the full
    covariance, evaluation.rotate_tril_sigma)."""
    k = logvar.shape[-1]
    diag = torch.exp(0.5 * logvar)
    lead = logvar.shape[:-1]
    rows, idx = [], 0
    for i in range(k):
        cols = []
        if i and _has_off(off):
            cols.append(off[..., idx:idx + i])
            idx += i
        elif i:
            cols.append(torch.zeros(lead + (i,), dtype=logvar.dtype,
                                    device=logvar.device))
        cols.append(diag[..., i:i + 1])
        if i + 1 < k:
            cols.append(torch.zeros(lead + (k - i - 1,), dtype=logvar.dtype,
                                    device=logvar.device))
        rows.append(torch.cat(cols, -1))
    return torch.stack(rows, -2)
