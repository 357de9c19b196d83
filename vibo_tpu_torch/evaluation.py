"""Evaluation suite (counterpart of `vibo_tpu.evaluation`, single device):
held-out imputation accuracy and calibration, the posterior means, the IWAE
test log-likelihood, the amortized new-person and new-item evals, the
Laplace (Fisher) widths of theta, per-person SVI refinement of q(theta),
and the latent-space comparisons of recovery and of posteriors across
methods (numpy and scipy, as in JAX's module).

Protocol (arXiv:2002.00276 sections 6.3-6.4): encode each person's
train-visible responses; push the posterior-mean ability and the
item-posterior means through the link and predict p > 0.5 on the hidden
cells (grm/gpcm: the most probable category); bound log p(r) of the hidden
cells with IWAE-S. Model-side reductions run in person blocks on the model's
device and bring back only their sums.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.stats
import torch
import torch.distributed as tdist

from vibo_tpu_torch.convert import tree_map
from vibo_tpu_torch.data.masking import Dataset
from vibo_tpu_torch.models import networks
from vibo_tpu_torch.models.vibo import VIBO
from vibo_tpu_torch.ops import distributions as dist
from vibo_tpu_torch.ops import likelihood as lik
from vibo_tpu_torch.ops import links, objectives
from vibo_tpu_torch.ops.links import CATEGORICAL_MODELS
from vibo_tpu_torch.parallel.mesh import pad_rows

_DEEP_CHUNK_BYTES = 2 << 30   # one deep-link activation of an IWAE chunk


def _rows_f32(x: np.ndarray, s: int, e: int, rows: int, dev) -> torch.Tensor:
    """x[s:e] as f32 on dev, zero-padded to `rows` rows."""
    out = np.zeros((rows, x.shape[1]), np.float32)
    out[:e - s] = x[s:e]
    return torch.from_numpy(out).to(dev)


def _person_blocks(n: int, block: int):
    for start in range(0, n, block):
        yield start, min(start + block, n)


@torch.no_grad()
def imputation_accuracy(model: VIBO, params, ds: Dataset,
                        block_size: int = 16384,
                        item_mean: dict | None = None) -> dict:
    """{"acc", "base_rate" (majority-class accuracy over the model's
    categories), "num_heldout"} over ds.heldout_mask, in person blocks of
    block_size on the model's device; grm/gpcm accuracy is the exact
    category match. item_mean: optional precomputed item means (default:
    full_item_mean on this dataset's train-visible matrix)."""
    if item_mean is None:
        item_mean = full_item_mean(model, params, ds)
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


@torch.no_grad()
def full_item_dist(model: VIBO, params, ds: Dataset) -> dict:
    """The item posterior every evaluation shares: free-form, the params'
    own; amortized (item_encoder), the encoder on the column statistics of
    ds's whole train-visible matrix (every training person, whatever the
    person blocking)."""
    if not model.cfg.item_encoder:
        return model.item_dist(params)
    dev = model.device
    resp, tmask = (torch.from_numpy(np.ascontiguousarray(x, np.float32)
                                    ).to(dev)
                   for x in (ds.response, ds.train_mask))
    return model.item_dist(params, resp, tmask)


def full_item_mean(model: VIBO, params, ds: Dataset) -> dict:
    """The item posterior's means (full_item_dist's "mu" of each item
    parameter)."""
    return {name: p["mu"]
            for name, p in full_item_dist(model, params, ds).items()}


@torch.no_grad()
def infer_posterior_means(model: VIBO, params, ds: Dataset,
                          block_size: int = 4096, return_sigma: bool = False,
                          return_scale_tril: bool = False):
    """Posterior-mean abilities (N, K) and the item-parameter means (a dict
    of numpy), the encoder conditioned on each person's train-visible
    responses and the item means, in person blocks of block_size (the last
    zero-padded, its padded rows dropped). return_sigma also returns the
    (N, K) marginal posterior standard deviations (the row norms of the
    covariance's Cholesky factor); return_scale_tril (implies
    return_sigma) also the (N, K, K) Cholesky factor itself
    (dist.tril_matrix), diag(sigma) for the diagonal family."""
    item_mean = full_item_mean(model, params, ds)
    dev = model.device
    n = ds.response.shape[0]
    rows = min(n, block_size)
    return_sigma = return_sigma or return_scale_tril
    thetas, sigmas, trils = [], [], []
    for s in range(0, n, rows):
        e = min(s + rows, n)
        resp, tmask = (_rows_f32(x, s, e, rows, dev)
                       for x in (ds.response, ds.train_mask))
        mu, logvar, off = model.encode(params, resp, tmask, item_mean)
        thetas.append(mu.cpu().numpy())
        if return_sigma:
            sigmas.append(dist.tril_marginal_sigma(logvar, off).cpu().numpy())
        if return_scale_tril:
            trils.append(dist.tril_matrix(logvar, off).cpu().numpy())
    out = (np.concatenate(thetas, 0)[:n],
           {k: v.detach().cpu().numpy() for k, v in item_mean.items()})
    if return_sigma:
        out = out + (np.concatenate(sigmas, 0)[:n],)
    if return_scale_tril:
        out = out + (np.concatenate(trils, 0)[:n],)
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
    use_pallas=False and its encoder conditioned on each sample's item
    draw (condition_on "mean" too), as the JAX evaluator does; samples run
    in chunks of at most 10 to bound the (chunk, B, M) logits, and for the
    deep link of as many as keep one (chunk, B, deep_item_chunk, H) f32
    activation of the plain link within _DEEP_CHUNK_BYTES (the bound's
    value does not depend on the chunking).

    Noise: noise(block_index, rows) -> (item_eps {name: (S, M, D)},
    theta_eps (S, rows, K)) when given (the tests replay the JAX keys
    through it), else model.sample_noise drawn from `generator`."""
    if on not in ("heldout", "train"):
        raise ValueError(f"on must be 'heldout' or 'train', got {on!r}")
    model = _iwae_model(model)
    dev = model.device
    n = ds.response.shape[0]
    rows = n if n <= block_size else block_size
    chunk = _iwae_chunk(model, num_samples, rows, ds.shape[1])
    emask_host = ds.train_mask if on == "train" else ds.heldout_mask
    post = full_item_dist(model, params, ds)
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


def _iwae_model(model: VIBO) -> VIBO:
    """The model the IWAE evaluators score with: use_pallas off, and the
    encoder conditioned on each sample's item draw whatever condition_on
    says, as JAX's evaluator does (vibo_tpu/evaluation.py:272), so "mean"
    is scored as "sample" (the same params)."""
    cfg = model.cfg
    if not (cfg.use_pallas or cfg.condition_on == "mean"):
        return model
    return VIBO(dataclasses.replace(
        cfg, use_pallas=False,
        condition_on=("sample" if cfg.condition_on == "mean"
                      else cfg.condition_on)), device=model.device)


def _iwae_chunk(model: VIBO, num_samples: int, rows: int, m: int) -> int:
    """Samples an IWAE chunk: the largest divisor of num_samples up to 10,
    for the deep link up to as many as keep one (chunk, rows,
    deep_item_chunk, H) f32 activation of the plain link within
    _DEEP_CHUNK_BYTES (the bound's value does not depend on it)."""
    cap = 10
    if model.cfg.irt_model == "deep":
        items = min(model.cfg.deep_item_chunk or m, m)
        cap = max(1, min(cap, _DEEP_CHUNK_BYTES // (
            4 * rows * items * model.cfg.deep_hidden_dim)))
    return max(d for d in range(1, min(num_samples, cap) + 1)
               if num_samples % d == 0)


def amortized_new_person_eval(model: VIBO, params, test_ds: Dataset,
                              block_size: int = 4096) -> dict:
    """The paper's headline capability (arXiv:2002.00276 section 6): the
    trained encoder infers posteriors for UNSEEN students in one forward
    pass. Scores test_ds's held-out cells from its train-visible responses
    (imputation_accuracy) and adds the scoring rate: `seconds` and
    `persons_per_sec` of the first pass, and `warm_seconds` /
    `warm_persons_per_sec` of a second one on the same data. Use with
    data.masking.split_persons (the same items)."""
    n = test_ds.response.shape[0]
    t0 = time.perf_counter()
    out = imputation_accuracy(model, params, test_ds, block_size)
    out["seconds"] = time.perf_counter() - t0
    out["persons_per_sec"] = n / max(out["seconds"], 1e-9)
    t0 = time.perf_counter()
    imputation_accuracy(model, params, test_ds, block_size)
    out["warm_seconds"] = time.perf_counter() - t0
    out["warm_persons_per_sec"] = n / max(out["warm_seconds"], 1e-9)
    return out


@torch.no_grad()
def amortized_new_item_eval(model: VIBO, params, train_ds: Dataset,
                            test_ds: Dataset, block_size: int = 4096) -> dict:
    """Cold start on NEW items (the dual of amortized_new_person_eval):
    the item encoder alone (new_items=True, no residuals) infers the
    posteriors of test_ds's columns from their train-visible cells, and
    those items' held-out cells are predicted (p > 0.5) from the abilities
    inferred on the TRAIN items (infer_posterior_means on train_ds). Needs
    item_encoder=True; train_ds / test_ds are data.masking.split_items'
    column split (same persons, disjoint items). Returns acc, base_rate
    (majority class), num_heldout, num_new_items, seconds, items_per_sec."""
    if not model.cfg.item_encoder:
        raise ValueError(
            "amortized_new_item_eval needs item_encoder=True: the free-form "
            "item posterior has no parameters for unseen items")
    dev = model.device
    t0 = time.perf_counter()
    resp, tmask, hmask = (
        torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        for x in (test_ds.response, test_ds.train_mask,
                  test_ds.heldout_mask))
    post = model.item_dist(params, resp, tmask, new_items=True)
    item_mean = {name: p["mu"] for name, p in post.items()}
    theta = torch.from_numpy(np.asarray(infer_posterior_means(
        model, params, train_ds, block_size)[0], np.float32)).to(dev)
    correct = total = ones = 0.0
    for s, e in _person_blocks(test_ds.response.shape[0], block_size):
        prob = model.response_prob(params, theta[s:e], item_mean)
        pred = (prob > 0.5).float()
        h = hmask[s:e]
        correct += float((h * (pred == resp[s:e])).sum())
        total += float(h.sum())
        ones += float((h * resp[s:e]).sum())
    seconds = time.perf_counter() - t0
    return {"acc": correct / max(total, 1.0),
            "base_rate": max(ones, total - ones) / max(total, 1.0),
            "num_heldout": int(total), "num_new_items": test_ds.shape[1],
            "seconds": seconds,
            "items_per_sec": test_ds.shape[1] / max(seconds, 1e-9)}


# ---------------------------------------------------------------- calibration


@torch.no_grad()
def _calib_stats(model: VIBO, params, item_mean: dict, resp, tmask, hmask,
                 bins: int = 10) -> torch.Tensor:
    """One person block's calibration sums on the model's device, (3 bins +
    1,) f64: per confidence bin the held-out cell count, the correct count
    and the summed confidence, then the Brier total. Binary links: the
    confidence is max(p, 1 - p) binned on [0.5, 1]; grm/gpcm: the largest
    category probability binned on [1/C, 1], correct the argmax match, the
    Brier term sum_c (p_c - 1[r = c])^2."""
    if model.cfg.irt_model in CATEGORICAL_MODELS:
        mu, _, _ = model.encode(params, resp, tmask, item_mean)
        logp = model.category_logprobs(params, mu, item_mean)   # (B, M, C)
        p_all = torch.exp(logp)
        conf = p_all.amax(-1)
        correct = (logp.argmax(-1).float() == resp).float()
        onehot = torch.nn.functional.one_hot(resp.long(), p_all.shape[-1])
        brier_cells = torch.square(p_all - onehot).sum(-1)
        lo = 1.0 / model.cfg.num_categories
        idx = ((conf - lo) / (1.0 - lo) * bins).to(torch.int32)
    else:
        prob = model.impute_prob_with_items(params, resp, tmask, item_mean)
        conf = torch.maximum(prob, 1.0 - prob)
        correct = ((prob > 0.5).float() == resp).float()
        brier_cells = torch.square(prob - resp)
        idx = ((conf - 0.5) * 2.0 * bins).to(torch.int32)
    idx = idx.clamp(0, bins - 1).reshape(-1).long()
    w = hmask.reshape(-1).double()
    out = torch.zeros(3 * bins + 1, dtype=torch.float64, device=resp.device)
    out[:bins].scatter_add_(0, idx, w)
    out[bins:2 * bins].scatter_add_(0, idx, w * correct.reshape(-1).double())
    out[2 * bins:3 * bins].scatter_add_(0, idx, w * conf.reshape(-1).double())
    out[3 * bins] = (w * brier_cells.reshape(-1).double()).sum()
    return out


def calibration(model: VIBO, params, ds: Dataset, bins: int = 10,
                block_size: int = 16384, item_mean: dict | None = None
                ) -> dict:
    """Posterior-predictive calibration of the held-out imputation
    probabilities (the imputation protocol's predictions): ECE, MCE, Brier
    and the bins (_calib_summary). Each person block's sums come back as
    3 bins + 1 numbers (_calib_stats); the probabilities stay on the
    device."""
    if item_mean is None:
        item_mean = full_item_mean(model, params, ds)
    dev = model.device
    total = np.zeros(3 * bins + 1)
    for s in range(0, ds.response.shape[0], block_size):
        e = min(s + block_size, ds.response.shape[0])
        resp, tmask, hmask = (
            torch.from_numpy(np.ascontiguousarray(x[s:e], np.float32)).to(dev)
            for x in (ds.response, ds.train_mask, ds.heldout_mask))
        total += _calib_stats(model, params, item_mean, resp, tmask, hmask,
                              bins).cpu().numpy()
    return _calib_summary(total[:bins], total[bins:2 * bins],
                          total[2 * bins:3 * bins], float(total[3 * bins]))


# ------------------------------------------------------------ Laplace widths


def laplace_theta_sigma(model: VIBO, params, ds: Dataset,
                        theta: np.ndarray | None = None,
                        block_size: int = 4096,
                        return_factor: bool = False):
    """Laplace (Fisher) posterior width of theta at the amortized mean:
    cov_i = (I_K + sum_j m_ij w_ij a_j a_j^T)^-1 over the train cells, in
    closed form for the linear and polytomous links
    (laplace_sigma_from_items) and through the link's Jacobian for the deep
    link (laplace_sigma_deep). theta: (N, K) posterior means (default:
    infer_posterior_means). Returns (N, K) marginal sds; return_factor also
    the (N, K, K) Cholesky factors of the covariance."""
    cfg = model.cfg
    if cfg.irt_model not in links.IRT_MODELS:
        raise ValueError(
            f"laplace_theta_sigma: unknown link {cfg.irt_model!r}")
    items = {k: v.detach().cpu().numpy()
             for k, v in full_item_mean(model, params, ds).items()}
    if theta is None:
        theta = infer_posterior_means(model, params, ds,
                                      block_size=block_size)[0]
    if cfg.irt_model == "deep":
        return laplace_sigma_deep(params["deep_link"], items["d"],
                                  ds.train_mask, theta,
                                  block_size=block_size,
                                  return_factor=return_factor,
                                  device=model.device)
    return laplace_sigma_from_items(items, cfg.irt_model, ds.train_mask,
                                    theta, block_size=block_size,
                                    return_factor=return_factor)


def laplace_sigma_from_items(items: dict, irt_model: str, mask, theta,
                             block_size: int = 4096,
                             return_factor: bool = False):
    """Core of laplace_theta_sigma on raw numpy arrays, in f64 (also the
    serving path, AbilityScorer.laplace_sigma). The Fisher weight w_ij of
    the cell's linear predictor: p(1-p) for 1PL/2PL,
    ((1-g) s (1-s))^2 / (p(1-p)) for 3PL, sum_c (s'_c - s'_{c+1})^2 / P_c
    for grm (the ordered thresholds from the unconstrained means), the
    category-score variance for gpcm (cumulative steps). The information is
    (m * w) @ (a_k a_l) over the pair basis plus I_K."""
    theta = np.asarray(theta, np.float64)
    n, k = theta.shape
    b = None
    if irt_model == "grm":
        bf = np.asarray(items["b"], np.float64)
        kappa = np.concatenate(
            [bf[:, :1], bf[:, :1] + np.cumsum(np.logaddexp(0.0, bf[:, 1:]),
                                              -1)], -1)
        m = kappa.shape[0]
    elif irt_model == "gpcm":
        kappa = np.cumsum(np.asarray(items["b"], np.float64), -1)
        m = kappa.shape[0]
    else:
        b = np.asarray(items["b"], np.float64).reshape(-1)
        m = b.shape[0]
    a = (np.ones((m, k)) if irt_model == "1pl"
         else np.asarray(items["a"], np.float64))
    mask = np.asarray(mask, np.float64)
    iu = np.triu_indices(k)
    a2 = a[:, iu[0]] * a[:, iu[1]]                         # (M, K(K+1)/2)
    sds = np.empty((n, k))
    factors = np.empty((n, k, k)) if return_factor else None
    eye = np.eye(k)
    for s, e in _person_blocks(n, block_size):
        if irt_model == "gpcm":
            eta = theta[s:e] @ a.T                          # (B, M)
            cats = np.arange(1, kappa.shape[-1] + 1, dtype=np.float64)
            z = eta[..., None] * cats - kappa[None]         # (B, M, C-1)
            z = np.concatenate([np.zeros(z.shape[:-1] + (1,)), z], -1)
            z -= z.max(-1, keepdims=True)
            pcat = np.exp(z)
            pcat /= pcat.sum(-1, keepdims=True)             # (B, M, C)
            call = np.arange(pcat.shape[-1], dtype=np.float64)
            e1 = (pcat * call).sum(-1)
            w = (pcat * call * call).sum(-1) - e1 * e1      # Var[c]
        elif irt_model == "grm":
            eta = theta[s:e] @ a.T                          # (B, M)
            sc = 1.0 / (1.0 + np.exp(-(eta[..., None] - kappa[None])))
            z = np.zeros(sc.shape[:-1] + (1,))
            s_lo = np.concatenate([np.ones_like(z), sc], -1)   # P(>= c)
            s_hi = np.concatenate([sc, np.zeros_like(z)], -1)  # P(>= c+1)
            pcat = np.clip(s_lo - s_hi, 1e-12, None)           # (B, M, C)
            d_lo = np.concatenate([z, sc * (1.0 - sc)], -1)
            d_hi = np.concatenate([sc * (1.0 - sc), z], -1)
            w = (np.square(d_lo - d_hi) / pcat).sum(-1)        # (B, M)
        else:
            eta = theta[s:e] @ a.T - b[None, :]
            p = 1.0 / (1.0 + np.exp(-eta))
            if irt_model == "3pl":
                g = 1.0 / (1.0 + np.exp(-np.asarray(items["g_hat"],
                                                    np.float64).reshape(-1)))
                s_ = p
                p = g[None, :] + (1.0 - g[None, :]) * s_
                w = ((1.0 - g[None, :]) * s_ * (1.0 - s_)) ** 2 \
                    / np.clip(p * (1.0 - p), 1e-12, None)
            else:
                w = p * (1.0 - p)
        flat = (mask[s:e] * w) @ a2                        # (B, pairs)
        info = np.empty((e - s, k, k))
        info[:, iu[0], iu[1]] = flat
        info[:, iu[1], iu[0]] = flat
        info += eye[None]
        cov = np.linalg.inv(info)
        sds[s:e] = np.sqrt(np.diagonal(cov, axis1=1, axis2=2))
        if return_factor:
            factors[s:e] = np.linalg.cholesky(cov)
    return (sds, factors) if return_factor else sds


def _deep_fisher(dp: dict, theta_b, d, mask_b, item_chunk: int):
    """Per-person (sds (B, K), chol (B, K, K)) of the Gauss-Newton Laplace
    covariance under the deep link, f32. The Jacobian of the logits wrt
    theta comes from K one-hot forward-mode JVPs (torch.func.jvp) through
    the plain link, one item chunk at a time: each person's logits depend
    on their own theta row only, so pushing the column e_k through gives
    the k-th Jacobian column of every person at once."""
    k = theta_b.shape[1]
    etas, cols = [], [[] for _ in range(k)]
    for dc in (d.split(item_chunk, 0) if item_chunk else (d,)):
        def eta_fn(th, dc=dc):
            return networks.apply_deep_link(dp, th, dc)
        for j in range(k):
            tangent = torch.zeros_like(theta_b)
            tangent[:, j] = 1.0
            eta, col = torch.func.jvp(eta_fn, (theta_b,), (tangent,))
            if j == 0:
                etas.append(eta)
            cols[j].append(col)
    eta = torch.cat(etas, -1)                                   # (B, M)
    jac = torch.stack([torch.cat(c, -1) for c in cols])         # (K, B, M)
    p = torch.sigmoid(eta)
    w = mask_b * p * (1.0 - p)
    info = torch.einsum("kbm,lbm->bkl", jac * w[None], jac)
    info = info + torch.eye(k, dtype=info.dtype, device=info.device)
    cov = torch.linalg.inv(info)
    sds = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    return sds, torch.linalg.cholesky(cov)


@torch.no_grad()
def laplace_sigma_deep(deep_params, d, mask, theta, block_size: int = 4096,
                       return_factor: bool = False, item_chunk: int = 256,
                       device=None):
    """Laplace width of theta under the DEEP link at the amortized mean:
    I_i = I_K + sum_j m_ij p_ij (1 - p_ij) J_ij J_ij^T, J_ij = d eta_ij /
    d theta_i (the Gauss-Newton / expected Fisher information; for a linear
    eta it is laplace_sigma_from_items' closed form), conditioned on the
    item-latent means d (M, L), in f32 on `device` (None: the device of
    deep_params' tensors, the card for numpy). Returns like
    laplace_sigma_from_items."""
    from vibo_tpu_torch._device import resolve_device
    if device is None:
        leaf = deep_params["w_theta"]
        device = leaf.device if isinstance(leaf, torch.Tensor) else None
    dev = resolve_device(device)
    dp = tree_map(lambda x: torch.as_tensor(np.array(
        x.detach().cpu() if isinstance(x, torch.Tensor) else x,
        np.float32), device=dev), deep_params)
    d_t = torch.as_tensor(np.asarray(d, np.float32), device=dev)
    theta = np.asarray(theta, np.float32)
    mask = np.asarray(mask, np.float32)
    n, k = theta.shape
    sds = np.empty((n, k))
    factors = np.empty((n, k, k)) if return_factor else None
    for s, e in _person_blocks(n, block_size):
        sd_b, ch_b = _deep_fisher(dp, torch.from_numpy(theta[s:e]).to(dev),
                                  d_t, torch.from_numpy(mask[s:e]).to(dev),
                                  item_chunk)
        sds[s:e] = sd_b.cpu().numpy().astype(np.float64)
        if return_factor:
            factors[s:e] = ch_b.cpu().numpy().astype(np.float64)
    return (sds, factors) if return_factor else sds


# ------------------------------------------------- semi-amortized refinement


def _refine_loglik(irt_model: str, items: dict, deep, theta, resp, tmask):
    """Masked loglik per person (S, B) of theta (S, B, K) under the item
    means (and the trained deep decoder)."""
    if irt_model == "deep":
        logits = networks.apply_deep_link(deep, theta, items["d"],
                                          item_chunk=256)
        return lik.masked_loglik_per_person(logits, resp, tmask)
    if irt_model in CATEGORICAL_MODELS:
        return lik.categorical_loglik_per_person(
            irt_model, links.grm_base(theta, items["a"]),
            links.categorical_table(irt_model, items["b"]), resp, tmask)
    b = items["b"].reshape(-1)
    g = items["g_hat"].reshape(-1) if irt_model == "3pl" else None
    logits = (links.logits_1pl(theta, b) if irt_model == "1pl"
              else links.logits_2pl(theta, items["a"], b))
    return lik.masked_loglik_per_person(logits, resp, tmask, g_hat=g)


def refine_block(irt_model: str, items: dict, deep, resp, tmask, mu0,
                 logvar0, steps: int, lr: float, num_samples: int,
                 noise: tuple | None = None,
                 generator: torch.Generator | None = None, off0=None):
    """Per-person SVI of q(theta) = N(mu, L L^T) for one block, from (mu0,
    logvar0, off0) (off0 None: the diagonal family, L = diag(exp(logvar /
    2)); else the Cholesky entries, refined too): `steps` Adam steps
    (optax.adam(lr)'s form: betas 0.9, 0.999, eps 1e-8, no clipping) over
    the (B, K) block on each
    person's own ELBO, E_eps[loglik] - KL(q || N(0, I)), the item means
    and the decoder fixed; then the paired before/after bounds on one
    shared draw. Draws: noise = (step_eps (steps, S, B, K), eval_eps (S,
    B, K)), else from `generator`, each step's in turn and the paired
    bounds' last. Returns (mu, sigma, tril, per0, per1) detached."""
    def draw(i):
        if noise is not None:
            return (noise[0][i] if i < steps else noise[1]).to(mu0.device)
        return torch.randn((num_samples,) + tuple(mu0.shape),
                           generator=generator, device=mu0.device)

    def neg_elbo(q, eps):
        theta = dist.tril_reparameterize_eps(eps, *q)
        ll = _refine_loglik(irt_model, items, deep, theta, resp,
                            tmask).mean(0)
        per = ll - dist.kl_standard_normal_tril(*q)
        return -per.sum(), per

    q0 = (mu0, logvar0, off0)
    q = tuple(None if t is None else t.detach().clone().requires_grad_(True)
              for t in q0)
    opt = torch.optim.Adam([t for t in q if t is not None], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            neg_elbo(q, draw(i))[0].backward()
            opt.step()
    with torch.no_grad():
        eps = draw(steps)
        per0 = neg_elbo(q0, eps)[1]
        per1 = neg_elbo(q, eps)[1]
        sigma = dist.tril_marginal_sigma(q[1], q[2])
        tril = dist.tril_matrix(q[1], q[2])
    return q[0].detach(), sigma, tril, per0, per1


def refine_theta_posterior(model: VIBO, params, ds: Dataset,
                           steps: int = 300, lr: float = 0.05,
                           num_samples: int = 8, seed: int = 0,
                           block_size: int = 4096, noise=None):
    """Semi-amortized ability posterior: per-person SVI refinement.

    Starts q(theta_i) at the encoder's output on the train-visible data and
    runs `steps` Adam steps of each person's own ELBO under the item
    means (and the trained deep decoder), all persons of a block at once
    (refine_block). Blocks: one of N rows when N <= block_size, else blocks
    of block_size rows over the data zero-padded to a multiple of it (the
    padded rows dropped from every output). The family follows
    cfg.theta_posterior: the Cholesky entries of chol and the laplace
    families are refined with mu and logvar.

    Noise: noise(block_index, rows) -> (step_eps (steps, S, rows, K),
    eval_eps (S, rows, K)) when given (the tests replay JAX's keys through
    it), else drawn from a generator on the model's device seeded with
    `seed`, each step's draw in turn and then the paired bound's.

    Returns (theta_mu (N, K), sigma (N, K), tril (N, K, K), info), info
    with JAX's keys: elbo_gain_per_person (the paired bounds' mean gain),
    persons_worse (gain below -1e-3), steps, num_samples."""
    cfg = model.cfg
    dev = model.device
    items = {k: v.detach()
             for k, v in full_item_mean(model, params, ds).items()}
    deep = (tree_map(lambda t: t.detach(), params["deep_link"])
            if cfg.irt_model == "deep" else None)
    generator = (None if noise is not None
                 else torch.Generator(device=dev).manual_seed(seed))
    n = ds.response.shape[0]
    rows = n if n <= block_size else block_size
    mus, sigmas, trils = [], [], []
    gain_sum, worse = 0.0, 0
    for bi, s in enumerate(range(0, n, rows)):
        e = min(s + rows, n)
        resp, tmask = (_rows_f32(x, s, e, rows, dev)
                       for x in (ds.response, ds.train_mask))
        with torch.no_grad():
            mu0, logvar0, off0 = model.encode(params, resp, tmask, items)
        mu, sigma, tril, per0, per1 = refine_block(
            cfg.irt_model, items, deep, resp, tmask, mu0, logvar0, steps,
            lr, num_samples, None if noise is None else noise(bi, rows),
            generator, off0)
        take = e - s
        mus.append(mu.cpu().numpy()[:take])
        sigmas.append(sigma.cpu().numpy()[:take])
        trils.append(tril.cpu().numpy()[:take])
        d = (per1 - per0).cpu().numpy()[:take]
        gain_sum += float(d.sum())
        worse += int((d < -1e-3).sum())
    info = {"elbo_gain_per_person": gain_sum / n, "persons_worse": worse,
            "steps": int(steps), "num_samples": int(num_samples)}
    return (np.concatenate(mus, 0), np.concatenate(sigmas, 0),
            np.concatenate(trils, 0), info)


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


def rotate_tril_sigma(scale_tril: np.ndarray, rotation: np.ndarray
                      ) -> np.ndarray:
    """Per-person marginal sds (N, K) of a FULL covariance L L^T transported
    through an orthogonal rotation W: sqrt(diag(W^T L L^T W)), the row
    norms of W^T L (the full-covariance counterpart of rotate_diag_sigma)."""
    scale_tril = np.asarray(scale_tril, np.float64)
    w = np.asarray(rotation, np.float64)
    a = np.einsum("kd,nkj->ndj", w, scale_tril)
    return np.sqrt((a ** 2).sum(-1))


def multiple_correlation(y: np.ndarray, X: np.ndarray) -> float:
    """Multiple correlation R of a scalar trait with a K-dim trait: the
    Pearson correlation of y with its least-squares prediction from X's
    columns and an intercept (cross-method theta agreement across unequal
    ability dims, where rotation alignment is undefined); 0 when either
    side is constant."""
    y = np.asarray(y, np.float64).reshape(-1)
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    Xc = np.column_stack([X, np.ones(len(y))])
    coef, *_ = np.linalg.lstsq(Xc, y, rcond=None)
    yhat = Xc @ coef
    if yhat.std() < 1e-12 or y.std() < 1e-12:
        return 0.0
    return float(np.corrcoef(y, yhat)[0, 1])


# ------------------------------------------------------ calibration (numpy)


def _calib_summary(cnt, acc, cf, brier) -> dict:
    """ECE (bin-count-weighted |accuracy - confidence|), MCE, Brier per
    held-out cell and the bins, from the per-bin sums."""
    cnt, acc, cf = (np.asarray(x, np.float64) for x in (cnt, acc, cf))
    total = cnt.sum()
    with np.errstate(invalid="ignore", divide="ignore"):
        bin_acc = np.where(cnt > 0, acc / np.maximum(cnt, 1), np.nan)
        bin_conf = np.where(cnt > 0, cf / np.maximum(cnt, 1), np.nan)
    gap = np.abs(np.nan_to_num(bin_acc - bin_conf))
    ece = float((cnt * gap).sum() / max(total, 1.0))
    mce = float(gap.max()) if total > 0 else float("nan")
    return {"ece": ece, "mce": mce,
            "brier": float(brier / max(total, 1.0)),
            "num_heldout": int(total),
            "bin_count": cnt.astype(int).tolist(),
            "bin_accuracy": np.round(bin_acc, 4).tolist(),
            "bin_confidence": np.round(bin_conf, 4).tolist()}


def calibration_from_probs(prob: np.ndarray, resp: np.ndarray,
                           hmask: np.ndarray, bins: int = 10) -> dict:
    """Calibration of any predictor's held-out probabilities (the
    baselines' posterior predictives): confidence max(p, 1 - p) in `bins`
    bins on [0.5, 1], and the Brier score."""
    prob = np.asarray(prob, np.float64)
    resp = np.asarray(resp, np.float64)
    hmask = np.asarray(hmask, np.float64)
    conf = np.maximum(prob, 1.0 - prob)
    correct = ((prob > 0.5) == (resp > 0.5)).astype(np.float64)
    idx = np.clip(((conf - 0.5) * 2.0 * bins).astype(int), 0, bins - 1)
    w = hmask.ravel()
    idx = idx.ravel()
    cnt = np.bincount(idx, weights=w, minlength=bins)
    acc = np.bincount(idx, weights=w * correct.ravel(), minlength=bins)
    cf = np.bincount(idx, weights=w * conf.ravel(), minlength=bins)
    brier = (w * np.square(prob - resp).ravel()).sum()
    return _calib_summary(cnt, acc, cf, brier)


def calibration_from_category_probs(prob: np.ndarray, resp: np.ndarray,
                                    hmask: np.ndarray, bins: int = 10
                                    ) -> dict:
    """Multiclass calibration_from_probs for (N, M, C) category
    probabilities: confidence the largest probability (binned on [1/C,
    1]), correct the argmax match, Brier sum_c (p_c - 1[r = c])^2."""
    prob = np.asarray(prob, np.float64)
    resp = np.asarray(resp, np.float64)
    hmask = np.asarray(hmask, np.float64)
    c = prob.shape[-1]
    conf = prob.max(-1)
    correct = (prob.argmax(-1) == resp).astype(np.float64)
    onehot = np.eye(c)[resp.astype(np.int64)]
    brier_cells = np.square(prob - onehot).sum(-1)
    lo = 1.0 / c
    idx = np.clip(((conf - lo) / (1.0 - lo) * bins).astype(int), 0, bins - 1)
    w = hmask.ravel()
    idx = idx.ravel()
    cnt = np.bincount(idx, weights=w, minlength=bins)
    acc = np.bincount(idx, weights=w * correct.ravel(), minlength=bins)
    cf = np.bincount(idx, weights=w * conf.ravel(), minlength=bins)
    brier = (w * brier_cells.ravel()).sum()
    return _calib_summary(cnt, acc, cf, brier)


# ---------------------------------------------- mesh-sharded evaluation (A9)


def _decode_bits(code: torch.Tensor, num_categories: int = 2) -> tuple:
    """uint8 bit-code -> (response, train_mask, heldout_mask) f32: binary
    data response | train << 1 | heldout << 2, polytomous data the category
    in bits 0-4 and the masks in bits 5 and 6 (JAX's layout)."""
    c = code.to(torch.int32)
    if num_categories > 2:
        return ((c & 31).float(), ((c >> 5) & 1).float(),
                ((c >> 6) & 1).float())
    return (c & 1).float(), ((c >> 1) & 1).float(), ((c >> 2) & 1).float()


def dataset_code_on_mesh(ds: Dataset, mesh) -> torch.Tensor:
    """This rank's rows of the dataset's uint8 bit-code (_decode_bits's
    layout) on its device: the rows padded to a multiple of the students
    axis, zero rows past the end (they decode to all-zero masks, so every
    reduction below ignores them). Only the rank's rows are coded and
    copied."""
    if ds.num_categories > 32:
        raise ValueError(
            f"num_categories={ds.num_categories} exceeds the uint8 "
            "bit-code's 32-category budget (bits 0-4; masks at bits 5/6)")
    lo, hi = mesh.student_rows(ds.response.shape[0])
    e = min(hi, ds.response.shape[0])
    code = np.zeros((hi - lo, ds.response.shape[1]), np.uint8)
    if e > lo:
        t = (ds.train_mask[lo:e] > 0).astype(np.uint8)
        h = (ds.heldout_mask[lo:e] > 0).astype(np.uint8)
        if ds.num_categories > 2:
            code[:e - lo] = (ds.response[lo:e].astype(np.uint8) | t << 5
                             | h << 6)
        else:
            code[:e - lo] = ((ds.response[lo:e] > 0).astype(np.uint8)
                             | t << 1 | h << 2)
    return torch.from_numpy(code).to(mesh.device)


@torch.no_grad()
def _impute_stats_sharded(model: VIBO, params, ds: Dataset, mesh,
                          bins: int, item_mean: dict | None,
                          block_size: int) -> np.ndarray:
    """The imputation and calibration sums of the whole dataset, summed
    over the students group: each rank decodes and scores its own rows (in
    blocks of block_size; the encoder is per-person, so nothing crosses
    the mesh before these sums) -> (3 bins + 1 + C,) f64: _calib_stats'
    bins and Brier total, then the held-out count of each category."""
    if item_mean is None:
        item_mean = full_item_mean(model, params, ds)
    cats = model.cfg.num_categories
    code = dataset_code_on_mesh(ds, mesh)
    total = torch.zeros(3 * bins + 1 + cats, dtype=torch.float64,
                        device=code.device)
    for s in range(0, code.shape[0], block_size):
        resp, tmask, hmask = _decode_bits(code[s:s + block_size], cats)
        total[:3 * bins + 1] += _calib_stats(model, params, item_mean, resp,
                                             tmask, hmask, bins)
        total[3 * bins + 1:] += torch.stack(
            [(hmask * (resp == c)).sum() for c in range(cats)]).double()
    tdist.all_reduce(total, group=mesh.students)
    return total.cpu().numpy()


def imputation_accuracy_sharded(model: VIBO, params, ds: Dataset, mesh,
                                item_mean: dict | None = None,
                                block_size: int = 16384) -> dict:
    """imputation_accuracy over a mesh: each rank scores its own rows of
    the bit-code (dataset_code_on_mesh) and only the sums cross the mesh,
    over the students group (the items axis repeats them). The same
    counts as the single-device evaluator, whose predictions it repeats."""
    bins = 10
    t = _impute_stats_sharded(model, params, ds, mesh, bins, item_mean,
                              block_size)
    total, correct = float(t[:bins].sum()), float(t[bins:2 * bins].sum())
    return {"acc": correct / max(total, 1.0),
            "base_rate": float(t[3 * bins + 1:].max()) / max(total, 1.0),
            "num_heldout": int(total)}


def calibration_sharded(model: VIBO, params, ds: Dataset, mesh,
                        bins: int = 10, item_mean: dict | None = None,
                        block_size: int = 16384) -> dict:
    """calibration over a mesh (the reduction of
    imputation_accuracy_sharded, the per-bin sums summed over the students
    group)."""
    t = _impute_stats_sharded(model, params, ds, mesh, bins, item_mean,
                              block_size)
    return _calib_summary(t[:bins], t[bins:2 * bins], t[2 * bins:3 * bins],
                          float(t[3 * bins]))


@torch.no_grad()
def iwae_loglik_sharded(model: VIBO, params, ds: Dataset, mesh,
                        num_samples: int = 100, on: str = "heldout",
                        generator: torch.Generator | None = None,
                        noise: tuple | None = None) -> dict:
    """iwae_loglik over a mesh, one block of all N persons: the noise is
    drawn whole on every rank (sample_noise on N rows from `generator`, or
    `noise` = (item_eps {name: (S, M, D)}, theta_eps (S, N, K)); padding
    rows get zero noise) and each rank keeps its rows, so the bound does not
    depend on the device count and equals iwae_loglik's when N fits its
    one block. Each rank sums its rows' log-weight terms a sample (the
    encoder on the train-visible cells, the loglik on the evaluated ones;
    padding rows evaluate none); the sums cross the mesh over the students
    group and the item log-ratio, the same on every rank, is added once."""
    if on not in ("heldout", "train"):
        raise ValueError(f"on must be 'heldout' or 'train', got {on!r}")
    model = _iwae_model(model)
    n = ds.response.shape[0]
    code = dataset_code_on_mesh(ds, mesh)
    resp, tmask, hmask = _decode_bits(code, model.cfg.num_categories)
    emask = tmask if on == "train" else hmask
    post = full_item_dist(model, params, ds)
    if noise is None:
        noise = model.sample_noise(n, num_samples, generator=generator)
    item_eps, theta_eps = noise
    item_eps = {k: v.to(mesh.device) for k, v in item_eps.items()}
    pad = pad_rows(n, mesh.num_students) - theta_eps.shape[1]
    theta_eps = torch.nn.functional.pad(theta_eps.to(mesh.device),
                                        (0, 0, 0, pad))
    lo, hi = mesh.student_rows(n)
    theta_eps = theta_eps[:, lo:hi]
    chunk = _iwae_chunk(model, num_samples, hi - lo, ds.shape[1])
    local, ratio = [], []
    for c in range(0, num_samples, chunk):
        lw, r = model.iwae_terms(
            params, resp, tmask, {k: v[c:c + chunk]
                                  for k, v in item_eps.items()},
            theta_eps[c:c + chunk], eval_mask=emask, post=post)
        local.append(lw)
        ratio.append(r)
    local = torch.cat(local)
    tdist.all_reduce(local, group=mesh.students)
    bound = objectives.iwae_bound(local + torch.cat(ratio))
    cells = float((ds.train_mask if on == "train" else ds.heldout_mask).sum())
    total = float(bound)
    return {"loglik": total, "loglik_per_cell": total / max(cells, 1.0),
            "num_cells": int(cells), "num_samples": num_samples}
