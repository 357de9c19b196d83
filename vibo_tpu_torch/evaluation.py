"""Held-out imputation accuracy, the posterior means and the IWAE test
log-likelihood (counterpart of `vibo_tpu.evaluation.imputation_accuracy`,
`full_item_dist`, `full_item_mean`, `infer_posterior_means` and
`iwae_loglik`), and the latent-space comparisons of recovery and of
posteriors across methods (`procrustes_rotation`, `procrustes_align`,
`rotate_diag_sigma`, `correlation`: numpy and scipy, as in JAX's module).

Protocol (arXiv:2002.00276 sections 6.3-6.4): encode each person's
train-visible responses; push the posterior-mean ability and the
item-posterior means through the link and predict p > 0.5 on the hidden
cells (grm/gpcm: the most probable category); bound log p(r) of the hidden
cells with IWAE-S.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.stats
import torch

from vibo_tpu_torch.data.masking import Dataset
from vibo_tpu_torch.models.vibo import VIBO
from vibo_tpu_torch.ops import distributions as dist
from vibo_tpu_torch.ops import objectives
from vibo_tpu_torch.ops.links import CATEGORICAL_MODELS

_DEEP_CHUNK_BYTES = 2 << 30   # one deep-link activation of an IWAE chunk


def _rows_f32(x: np.ndarray, s: int, e: int, rows: int, dev) -> torch.Tensor:
    """x[s:e] as f32 on dev, zero-padded to `rows` rows."""
    out = np.zeros((rows, x.shape[1]), np.float32)
    out[:e - s] = x[s:e]
    return torch.from_numpy(out).to(dev)


@torch.no_grad()
def imputation_accuracy(model: VIBO, params, ds: Dataset,
                        block_size: int = 16384,
                        item_mean: dict | None = None) -> dict:
    """{"acc", "base_rate" (majority-class accuracy over the model's
    categories), "num_heldout"} over ds.heldout_mask, in person blocks of
    block_size on the model's device; grm/gpcm accuracy is the exact
    category match. item_mean: optional precomputed item means (default:
    the posterior's)."""
    if item_mean is None:
        item_mean = model.item_posterior_mean(params)
    dev = model.device
    cats = model.cfg.num_categories
    correct, total = 0.0, 0.0
    counts = np.zeros(cats)
    for s in range(0, ds.response.shape[0], block_size):
        e = min(s + block_size, ds.response.shape[0])
        resp, tmask, hmask = (torch.from_numpy(np.ascontiguousarray(x[s:e],
                                                                    np.float32)
                                               ).to(dev)
                              for x in (ds.response, ds.train_mask,
                                        ds.heldout_mask))
        if model.cfg.irt_model in CATEGORICAL_MODELS:
            pred = model.impute_category_with_items(params, resp, tmask,
                                                    item_mean).float()
        else:
            prob = model.impute_prob_with_items(params, resp, tmask,
                                                item_mean)
            pred = (prob > 0.5).float()
        correct += float((hmask * (pred == resp)).sum())
        total += float(hmask.sum())
        counts += [float((hmask * (resp == c)).sum()) for c in range(cats)]
    return {"acc": correct / max(total, 1.0),
            "base_rate": float(counts.max()) / max(total, 1.0),
            "num_heldout": int(total)}


def full_item_dist(model: VIBO, params) -> dict:
    """The item posterior every evaluation shares. Free-form (the port's
    scope) it does not depend on the data; the amortized item encoder that
    pools the dataset's columns comes with ROADMAP's "Posterior and
    conditioning families"."""
    return model.item_dist(params)


def full_item_mean(model: VIBO, params) -> dict:
    """The item posterior's means (full_item_dist's "mu" of each item
    parameter)."""
    return {name: p["mu"] for name, p in full_item_dist(model,
                                                        params).items()}


@torch.no_grad()
def infer_posterior_means(model: VIBO, params, ds: Dataset,
                          block_size: int = 4096, return_sigma: bool = False,
                          return_scale_tril: bool = False):
    """Posterior-mean abilities (N, K) and the item-parameter means (a dict
    of numpy), the encoder conditioned on each person's train-visible
    responses and the item means, in person blocks of block_size (the last
    zero-padded, its padded rows dropped). return_sigma also returns the
    (N, K) posterior standard deviations; return_scale_tril (implies
    return_sigma) also the (N, K, K) Cholesky factor of the posterior
    covariance, diag(sigma) for the diagonal family."""
    item_mean = full_item_mean(model, params)
    dev = model.device
    n = ds.response.shape[0]
    rows = min(n, block_size)
    return_sigma = return_sigma or return_scale_tril
    thetas, sigmas = [], []
    for s in range(0, n, rows):
        e = min(s + rows, n)
        resp, tmask = (_rows_f32(x, s, e, rows, dev)
                       for x in (ds.response, ds.train_mask))
        mu, logvar, off = model.encode(params, resp, tmask, item_mean)
        thetas.append(mu.cpu().numpy())
        if return_sigma:
            sigmas.append(dist.tril_marginal_sigma(logvar, off).cpu().numpy())
    out = (np.concatenate(thetas, 0)[:n],
           {k: v.detach().cpu().numpy() for k, v in item_mean.items()})
    if return_sigma:
        out = out + (np.concatenate(sigmas, 0)[:n],)
    if return_scale_tril:
        sigma = out[2]
        out = out + (sigma[:, :, None] * np.eye(sigma.shape[1],
                                                dtype=sigma.dtype),)
    return out


@torch.no_grad()
def iwae_loglik(model: VIBO, params, ds: Dataset, num_samples: int = 100,
                block_size: int = 16384, on: str = "heldout",
                generator: torch.Generator | None = None,
                noise=None) -> dict:
    """IWAE-S bound on log p(r) over the evaluated cells, summed over person
    blocks: on='heldout' (the paper's test metric) the hidden cells, on=
    'train' the training ones. The encoder conditions on the train-visible
    responses either way.

    Blocks: one block of N rows when N <= block_size, else blocks of
    block_size rows over the data zero-padded to a multiple of it; padded
    rows have no evaluated cell and drop out of every term. Each block's
    bound counts the shared item terms with item_scale = real rows / N, so
    they sum to exactly one count over the dataset. The model runs with
    use_pallas=False, as the JAX evaluator does; samples run in chunks of
    at most 10 to bound the (chunk, B, M) logits, and for the deep link of
    as many as keep one (chunk, B, deep_item_chunk, H) f32 activation of the
    plain link within _DEEP_CHUNK_BYTES (the bound's value does not depend
    on the chunking).

    Noise: noise(block_index, rows) -> (item_eps {name: (S, M, D)},
    theta_eps (S, rows, K)) when given (the tests replay the JAX keys
    through it), else model.sample_noise drawn from `generator`."""
    if on not in ("heldout", "train"):
        raise ValueError(f"on must be 'heldout' or 'train', got {on!r}")
    if model.cfg.use_pallas:
        model = VIBO(dataclasses.replace(model.cfg, use_pallas=False),
                     device=model.device)
    dev = model.device
    n = ds.response.shape[0]
    rows = n if n <= block_size else block_size
    cap = 10
    if model.cfg.irt_model == "deep":
        items = min(model.cfg.deep_item_chunk or ds.shape[1], ds.shape[1])
        cap = max(1, min(cap, _DEEP_CHUNK_BYTES // (
            4 * rows * items * model.cfg.deep_hidden_dim)))
    chunk = max(d for d in range(1, min(num_samples, cap) + 1)
                if num_samples % d == 0)
    emask_host = ds.train_mask if on == "train" else ds.heldout_mask
    post = full_item_dist(model, params)
    total, cells = 0.0, 0.0
    for bi, s in enumerate(range(0, n, rows)):
        e = min(s + rows, n)
        resp, tmask, emask = (_rows_f32(x, s, e, rows, dev)
                              for x in (ds.response, ds.train_mask,
                                        emask_host))
        if noise is None:
            item_eps, theta_eps = model.sample_noise(rows, num_samples,
                                                     generator=generator)
        else:
            item_eps, theta_eps = noise(bi, rows)
        log_w = [model.iwae_log_weights(
                     params, resp, tmask,
                     {k: v[c:c + chunk] for k, v in item_eps.items()},
                     theta_eps[c:c + chunk], (e - s) / n, eval_mask=emask,
                     post=post)
                 for c in range(0, num_samples, chunk)]
        total += float(objectives.iwae_bound(torch.cat(log_w)))
        cells += float(emask_host[s:e].sum())
    return {"loglik": total, "loglik_per_cell": total / max(cells, 1.0),
            "num_cells": int(cells), "num_samples": num_samples}


# ------------------------------------------------- latent-space comparisons


def procrustes_rotation(inferred: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """(K, K) orthogonal W = UV^T minimizing ||inferred @ W - truth||_F,
    SVD(inferred^T truth) = U S V^T."""
    inferred = np.asarray(inferred, np.float64)
    truth = np.asarray(truth, np.float64)
    u, _, vt = np.linalg.svd(inferred.T @ truth)
    return u @ vt


def procrustes_align(inferred: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Rotate inferred (N, K) onto truth with the orthogonal Procrustes
    solution: multidimensional IRT latents are identified only up to an
    orthogonal transform of (theta, a) jointly."""
    inferred = np.asarray(inferred, np.float64)
    return inferred @ procrustes_rotation(inferred, truth)


def rotate_diag_sigma(sigma: np.ndarray, rotation: np.ndarray) -> np.ndarray:
    """Per-person posterior sds (N, K) transported through an orthogonal
    rotation W of the latent space: sqrt(sum_k W[k, d]^2 sigma_i,k^2), so
    two methods' uncertainties compare in one frame."""
    sigma = np.asarray(sigma, np.float64)
    return np.sqrt((sigma ** 2) @ (np.asarray(rotation, np.float64) ** 2))


def correlation(inferred: np.ndarray, truth: np.ndarray,
                align_sign: bool = True, align_rotation: bool = False) -> dict:
    """Pearson/Spearman correlation per trailing dim, averaged.

    align_sign flips each inferred dim to correlate positively with truth
    (the deciding sign is that of p + s); align_rotation applies the
    orthogonal Procrustes alignment first. A constant or near-constant dim
    (its statistics not finite) counts as 0."""
    inferred = np.asarray(inferred, np.float64)
    truth = np.asarray(truth, np.float64)
    if inferred.ndim == 1:
        inferred, truth = inferred[:, None], truth[:, None]
    if align_rotation and truth.shape[1] > 1:
        inferred = procrustes_align(inferred, truth)
    pearsons, spearmans = [], []
    for d in range(truth.shape[1]):
        x, y = inferred[:, d], truth[:, d]
        if np.std(x) == 0.0 or np.std(y) == 0.0:
            pearsons.append(0.0)
            spearmans.append(0.0)
            continue
        p = scipy.stats.pearsonr(x, y).statistic
        s = scipy.stats.spearmanr(x, y).statistic
        if not (np.isfinite(p) and np.isfinite(s)):
            pearsons.append(0.0)
            spearmans.append(0.0)
            continue
        if align_sign and p + s < 0:
            p, s = -p, -s
        pearsons.append(p)
        spearmans.append(s)
    return {"pearson": float(np.mean(pearsons)),
            "spearman": float(np.mean(spearmans))}
