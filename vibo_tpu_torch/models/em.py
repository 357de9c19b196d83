"""EM baseline: Bock-Aitkin marginal maximum likelihood with Gauss-Hermite
quadrature (counterpart of `vibo_tpu.models.em`, same names and result
keys).

1PL/3PL are the classical K = 1 forms; 2PL also runs at K = 2-4 on a
tensor-product grid (per-dim nodes 21/13/9 by default); the polytomous
families (grm, gpcm) run at K = 1 with their items in the unconstrained
coordinates VIBO, MLE and HMC share (`links.categorical_table`).

- E-step: per-person posterior weights over the nodes from (N, M) @ (M, Q)
  products of the masked responses against the per-node item
  log-probabilities (one product per category for grm/gpcm), then a
  logsumexp over the nodes.
- M-step: per-item Newton on the expected complete-data log-likelihood
  for (a, b) (K = 1 closed form; K > 1 a batched (K+1) x (K+1) solve);
  Fisher scoring with a N(g_prior_mean, g_prior_var) MAP prior on the 3PL
  guess logit; damped Newton over (a, b_free) for grm/gpcm, its gradient
  and Hessian by autodiff vmapped over the items (gpcm with a N(0, 1)
  ridge).

Plain PyTorch on the device, as JAX's is plain XLA: no kernel. The E-step
products are f32 matmuls (`resolve_device` turns TF32 off; TF32 would move
the log marginal at about 1e-3). `host_chunk` iterations run between host
fetches of their marginal log-likelihoods, as JAX's scanned chunks do: the
convergence test stops `iterations` inside a chunk while the params have
gone on to the chunk's end, and the first test compares against -inf.
`stats()` gives the host fetches and the fetched log-liks since
`reset_stats()`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.ops import likelihood as lik
from vibo_tpu_torch.ops import links

_STATS = {"host_fetches": 0, "log_liks": []}


def reset_stats() -> None:
    _STATS["host_fetches"] = 0
    _STATS["log_liks"] = []


def stats() -> dict:
    """Since reset_stats(): the host fetches, and every computed
    iteration's marginal log-lik in order (a chunk's past the stop too)."""
    return {"host_fetches": _STATS["host_fetches"],
            "log_liks": list(_STATS["log_liks"])}


@dataclasses.dataclass(frozen=True)
class EMConfig:
    irt_model: str = "2pl"         # 1pl | 2pl | 3pl | grm | gpcm
    ability_dim: int = 1           # K > 1 (2pl only): tensor-product grid
    num_categories: int = 2        # grm/gpcm only: C response categories
    num_quadrature: int = 61       # per-dim nodes at K = 1
    nodes_per_dim: int = 0         # per-dim nodes at K > 1; 0 = auto
                                   # (21 at K = 2, 13 at K = 3, 9 at K = 4)
    max_iters: int = 100
    newton_steps: int = 8
    tol: float = 1e-4              # relative marginal-loglik change
    seed: int = 0
    host_chunk: int = 5            # EM iterations between host fetches
    g_prior_mean: float = -1.5     # MAP prior on the 3PL guess logit
    g_prior_var: float = 1.0


def gauss_hermite_nodes(q: int, device=None):
    """Nodes and weights (f32) for integrating against N(0, 1)."""
    x, w = np.polynomial.hermite_e.hermegauss(q)   # probabilists' Hermite
    w = w / w.sum()
    return (torch.tensor(x, dtype=torch.float32, device=device),
            torch.tensor(w, dtype=torch.float32, device=device))


def gauss_hermite_grid(q: int, k: int, device=None):
    """Tensor-product grid for theta ~ N(0, I_k): nodes (q**k, k) and the
    normalized log-weights (q**k,)."""
    x1, w1 = np.polynomial.hermite_e.hermegauss(q)
    w1 = w1 / w1.sum()
    grids = np.meshgrid(*([x1] * k), indexing="ij")
    nodes = np.stack([g.reshape(-1) for g in grids], axis=-1)
    logw = np.zeros(q ** k)
    for g in np.meshgrid(*([np.log(w1)] * k), indexing="ij"):
        logw = logw + g.reshape(-1)
    return (torch.tensor(nodes, dtype=torch.float32, device=device),
            torch.tensor(logw, dtype=torch.float32, device=device))


def _item_logits(nodes, a, b):
    """Node x item logits theta_q . a_j - b_j -> (Q, M): the broadcast
    expression at K = 1 (nodes (Q,), a (M,)), one matmul on the grid
    (nodes (G, K), a (M, K))."""
    if nodes.dim() == 1:
        return nodes[:, None] * a[None, :] - b[None, :]
    return nodes @ a.T - b[None, :]


def _item_prob(nodes, a, b, g_hat=None):
    """(Q, M) response probability a node and item; 3PL when g_hat given."""
    s = torch.sigmoid(_item_logits(nodes, a, b))
    if g_hat is None:
        return s
    g = torch.sigmoid(g_hat)[None, :]
    return g + (1.0 - g) * s


def _posterior(ll_nq, log_w):
    """Posterior node weights and the summed marginal log-lik from the
    (N, Q) log-likelihoods and the nodes' log-weights."""
    log_joint = ll_nq + log_w[None, :]
    log_marg = torch.logsumexp(log_joint, dim=1)
    return torch.exp(log_joint - log_marg[:, None]), log_marg.sum()


def e_step(resp, mask, nodes, log_w, a, b, g_hat=None):
    """Posterior node weights (N, Q) and the marginal log-lik (0-d)."""
    if g_hat is None:
        logits = _item_logits(nodes, a, b)
        log_p = -F.softplus(-logits)
        log_1mp = -F.softplus(logits)
    else:
        p = _item_prob(nodes, a, b, g_hat).clamp(1e-6, 1.0 - 1e-6)
        log_p = torch.log(p)
        log_1mp = torch.log1p(-p)
    return _posterior((resp * mask) @ log_p.T
                      + ((1.0 - resp) * mask) @ log_1mp.T, log_w)


def m_step(resp, mask, post, nodes, a, b, newton_steps, estimate_a):
    """Per-item Newton for (a, b) on the expected complete-data loglik
    from the sufficient statistics n_qj = sum_i post_iq mask_ij and s_qj =
    sum_i post_iq mask_ij r_ij; K > 1 grids go to _m_step_multi."""
    if nodes.dim() == 2:
        return _m_step_multi(resp, mask, post, nodes, a, b, newton_steps)
    n_qj = post.T @ mask
    s_qj = post.T @ (resp * mask)
    x = nodes[:, None]
    for _ in range(newton_steps):
        p = torch.sigmoid(_item_logits(nodes, a, b))
        w = n_qj * p * (1.0 - p)
        err = s_qj - n_qj * p
        grad_a = (x * err).sum(0)
        grad_b = -err.sum(0)
        h_aa = (x * x * w).sum(0) + 1e-6
        h_bb = w.sum(0) + 1e-6
        h_ab = -(x * w).sum(0)
        if estimate_a:
            det = h_aa * h_bb - h_ab * h_ab
            da = (h_bb * grad_a - h_ab * grad_b) / det
            db = (-h_ab * grad_a + h_aa * grad_b) / det
            a = (a + da).clamp(0.05, 10.0)
            b = b + db
        else:
            b = b + grad_b / h_bb
    return a, b


def _m_step_multi(resp, mask, post, nodes, a, b, newton_steps):
    """Multidimensional 2PL M-step: joint Newton over (a_j in R^K, b_j)
    with features [theta_q, -1], all M items' (K+1) x (K+1) systems in one
    batched solve. Loadings are signed (the multidimensional likelihood is
    rotation-invariant; evaluation aligns frames by Procrustes)."""
    g, k = nodes.shape
    n_qj = post.T @ mask
    s_qj = post.T @ (resp * mask)
    feat = torch.cat([nodes, -torch.ones((g, 1), dtype=nodes.dtype,
                                         device=nodes.device)], dim=-1)
    # the Fisher matrices as one (M, G) @ (G, (K+1)^2) product against the
    # features' outer products (no (G, M, K+1, K+1) temporary)
    outer = (feat[:, :, None] * feat[:, None, :]).reshape(g, -1)
    ridge = 1e-4 * torch.eye(k + 1, dtype=nodes.dtype, device=nodes.device)
    for _ in range(newton_steps):
        p = torch.sigmoid(_item_logits(nodes, a, b))
        w = n_qj * p * (1.0 - p)
        err = s_qj - n_qj * p
        grad = err.T @ feat                                   # (M, K+1)
        fisher = (w.T @ outer).reshape(-1, k + 1, k + 1) + ridge
        step = torch.linalg.solve(fisher, grad[..., None])[..., 0]
        a = (a + step[:, :-1]).clamp(-10.0, 10.0)
        b = b + step[:, -1]
    return a, b


def m_step_3pl(resp, mask, post, nodes, a, b, g_hat, newton_steps,
               g_prior_mean, g_prior_var):
    """Per-item Fisher scoring for (a, b, g~) with the MAP prior on g~
    (the Fisher information is PSD where 3PL's observed information is
    not); 3 x 3 solves batched over the items."""
    n_qj = post.T @ mask
    s_qj = post.T @ (resp * mask)
    x = nodes[:, None]
    ridge = torch.diag(torch.tensor([1e-3, 1e-3, 1e-3 + 1.0 / g_prior_var],
                                    dtype=torch.float32, device=a.device))
    for _ in range(newton_steps):
        sig = torch.sigmoid(_item_logits(nodes, a, b))
        g = torch.sigmoid(g_hat)[None, :]
        p = (g + (1.0 - g) * sig).clamp(1e-6, 1.0 - 1e-6)
        pq = p * (1.0 - p)
        err = (s_qj - n_qj * p) / pq
        dp_dl = (1.0 - g) * sig * (1.0 - sig)
        dp_dg = (1.0 - sig) * (g * (1.0 - g))
        grad = torch.stack([
            (x * err * dp_dl).sum(0),
            -(err * dp_dl).sum(0),
            (err * dp_dg).sum(0) - (g_hat - g_prior_mean) / g_prior_var,
        ], dim=-1)                                            # (M, 3)
        w = n_qj / pq
        da = torch.stack([x * dp_dl, -dp_dl, dp_dg], dim=-1)  # (Q, M, 3)
        fisher = torch.einsum("qm,qmi,qmj->mij", w, da, da) + ridge
        step = torch.linalg.solve(fisher, grad[..., None])[..., 0]
        a = (a + step[:, 0]).clamp(0.05, 10.0)
        b = b + step[:, 1]
        g_hat = (g_hat + step[:, 2]).clamp(-6.0, 1.0)
    return a, b, g_hat


def _categorical_node_logprob(irt_model, nodes, a, b_free):
    """(Q, M, C) log P(r = c | theta_q, a_j, b_free_j) over the nodes."""
    base = nodes[:, None] * a[None, :]
    table = links.categorical_table(irt_model, b_free)
    return lik.categorical_logprob_all(irt_model, base, table)


def e_step_grm(resp, mask, nodes, log_w, a, b_free, num_categories,
               irt_model="grm"):
    """Polytomous E-step: posterior node weights (N, Q) and the marginal
    log-lik, one masked indicator matmul a category against the node
    log-probability table."""
    logp = _categorical_node_logprob(irt_model, nodes, a, b_free)
    ll_nq = torch.zeros((resp.shape[0], nodes.shape[0]), dtype=logp.dtype,
                        device=logp.device)
    for c in range(num_categories):
        ll_nq = ll_nq + (mask * (resp == c)) @ logp[:, :, c].T
    return _posterior(ll_nq, log_w)


def m_step_grm(n_qjc, nodes, a, b_free, newton_steps, irt_model="grm",
               prior_var=None):
    """Per-item damped Newton over (a_j, b_free_j) on the expected
    complete-data grm/gpcm loglik from n_qjc (Q, M, C) = sum_i post_iq
    mask_ij 1[r_ij = c]; prior_var: a N(0, prior_var) MAP ridge on the
    unconstrained coordinates (gpcm's default; None keeps pure MML).

    The gradient and Hessian of one item's objective come from autodiff
    (torch.func), vmapped over the items; ridge 1e-3 on -H, steps clipped
    to +-2, loadings signed in [-10, 10]."""

    def obj(p, n_qc):
        base = (nodes * p[0])[:, None]
        table = links.categorical_table(irt_model, p[1:][None, :])
        logp = lik.categorical_logprob_all(irt_model, base, table)[:, 0, :]
        out = (n_qc * logp).sum()
        if prior_var is not None:
            out = out - 0.5 * (p * p).sum() / prior_var
        return out

    grad_fn = torch.func.vmap(torch.func.grad(obj))
    hess_fn = torch.func.vmap(torch.func.hessian(obj))
    n_jqc = n_qjc.permute(1, 0, 2)
    eye = torch.eye(1 + b_free.shape[1], dtype=a.dtype, device=a.device)
    for _ in range(newton_steps):
        p = torch.cat([a[:, None], b_free], dim=1)
        g = grad_fn(p, n_jqc)
        h = -hess_fn(p, n_jqc) + 1e-3 * eye
        step = torch.linalg.solve(h, g[..., None])[..., 0].clamp(-2.0, 2.0)
        p = p + step
        a, b_free = p[:, 0].clamp(-10.0, 10.0), p[:, 1:]
    return a, b_free


def _grm_threshold_init(resp, mask, num_categories):
    """Moment-matched b_free from the empirical cumulative proportions:
    kappa_c = -logit(P(r >= c)), mapped back through the softplus-cumsum
    (gaps floored at 1e-2). numpy in, numpy out (f32)."""
    resp, mask = np.asarray(resp, np.float32), np.asarray(mask, np.float32)
    obs = mask.sum(0) + 1.0
    kappas = []
    for c in range(1, num_categories):
        p_ge = ((mask * (resp >= c)).sum(0) + 0.5) / obs
        p_ge = np.clip(p_ge, 1e-3, 1.0 - 1e-3)
        kappas.append(-np.log(p_ge / (1.0 - p_ge)))
    kappa = np.stack(kappas, axis=-1)
    b0 = np.empty_like(kappa)
    b0[:, 0] = kappa[:, 0]
    if kappa.shape[1] > 1:
        gaps = np.maximum(np.diff(kappa, axis=-1), 1e-2)
        b0[:, 1:] = np.log(np.expm1(gaps))
    return b0.astype(np.float32)


def _gpcm_step_init(resp, mask, num_categories):
    """Moment-matched GPCM steps delta_c = log(P(c-1) / P(c)) from the
    items' category counts (+0.5 smoothing). numpy in, numpy out (f32)."""
    resp, mask = np.asarray(resp, np.float32), np.asarray(mask, np.float32)
    deltas = []
    prev = (mask * (resp == 0)).sum(0) + 0.5
    for c in range(1, num_categories):
        cur = (mask * (resp == c)).sum(0) + 0.5
        deltas.append(np.log(prev / cur))
        prev = cur
    return np.stack(deltas, axis=-1).astype(np.float32)


def _run(one_iter, params, cfg: EMConfig):
    """EM iterations in chunks of host_chunk with one host fetch of the
    chunk's marginal log-likelihoods each; returns (params, iterations)."""
    chunk = max(1, min(cfg.host_chunk, cfg.max_iters))
    prev = -np.inf
    iters = 0
    done = False
    while iters < cfg.max_iters and not done:
        lls = []
        for _ in range(chunk):
            params, ll = one_iter(params)
            lls.append(ll)
        lls = torch.stack(lls).cpu().numpy()   # ONE host fetch a chunk
        _STATS["host_fetches"] += 1
        _STATS["log_liks"].extend(float(x) for x in lls)
        for ll in lls:
            iters += 1
            if abs(ll - prev) < cfg.tol * abs(prev):
                done = True
                break
            prev = float(ll)
    return params, iters


@torch.no_grad()
def fit_em(resp, mask, cfg: EMConfig, device=None) -> dict:
    """Run EM to convergence on the card (device=None) or on `device`.
    Returns numpy a, b [, g_hat], theta_eap, log_marginal, iterations,
    nodes and posterior_node_weights (grm/gpcm: also the family's table,
    irt_model and num_categories)."""
    if cfg.irt_model not in ("1pl", "2pl", "3pl", "grm", "gpcm"):
        raise ValueError("EM baseline supports irt_model in "
                         "{'1pl','2pl','3pl','grm','gpcm'}")
    if cfg.irt_model in ("grm", "gpcm"):
        return _fit_em_categorical(resp, mask, cfg, device)
    k = cfg.ability_dim
    if k > 1 and cfg.irt_model != "2pl":
        raise ValueError(
            "multidimensional EM is 2pl-only (1PL's summed-theta link and "
            "3PL's guess parameter are K=1 classical forms)")
    if k > 4:
        raise ValueError(
            f"ability_dim={k}: the tensor-product grid is capped at K=4 "
            "(9^4 nodes); use VIBO/MLE/HMC beyond that")
    dev = resolve_device(device)
    resp = torch.as_tensor(np.asarray(resp, np.float32), device=dev)
    mask = torch.as_tensor(np.asarray(mask, np.float32), device=dev)
    m = resp.shape[1]
    if k == 1:
        nodes, w = gauss_hermite_nodes(cfg.num_quadrature, dev)
        log_w = torch.log(w)
    else:
        per_dim = cfg.nodes_per_dim or {2: 21, 3: 13, 4: 9}[k]
        nodes, log_w = gauss_hermite_grid(per_dim, k, dev)
    is_3pl = cfg.irt_model == "3pl"
    estimate_a = cfg.irt_model != "1pl"
    if k == 1:
        a0 = torch.ones((m,), dtype=torch.float32, device=dev)
    else:
        # symmetry broken: unit loading on dim 0 plus a small seeded
        # perturbation (a shared loading direction is a saddle)
        rng = np.random.default_rng(cfg.seed)
        a0 = np.zeros((m, k), np.float32)
        a0[:, 0] = 1.0
        a0 += 0.1 * rng.standard_normal((m, k)).astype(np.float32)
        a0 = torch.as_tensor(a0, device=dev)
    pval = ((resp * mask).sum(0) + 0.5) / (mask.sum(0) + 1.0)
    b0 = -torch.log(pval / (1.0 - pval))
    g0 = (torch.full((m,), cfg.g_prior_mean, dtype=torch.float32,
                     device=dev) if is_3pl else None)

    def one_iter(params):
        a, b, g_hat = params
        post, ll = e_step(resp, mask, nodes, log_w, a, b, g_hat)
        if is_3pl:
            return m_step_3pl(resp, mask, post, nodes, a, b, g_hat,
                              cfg.newton_steps, cfg.g_prior_mean,
                              cfg.g_prior_var), ll
        a, b = m_step(resp, mask, post, nodes, a, b, cfg.newton_steps,
                      estimate_a)
        return (a, b, g_hat), ll

    (a, b, g_hat), iters = _run(one_iter, (a0, b0, g0), cfg)
    post, ll = e_step(resp, mask, nodes, log_w, a, b, g_hat)
    out = {"a": a.cpu().numpy(), "b": b.cpu().numpy(),
           "theta_eap": (post @ nodes).cpu().numpy(),
           "log_marginal": float(ll), "iterations": iters,
           "nodes": nodes.cpu().numpy(),
           "posterior_node_weights": post.cpu().numpy()}
    if is_3pl:
        out["g_hat"] = g_hat.cpu().numpy()
    return out


def _fit_em_categorical(resp, mask, cfg: EMConfig, device=None) -> dict:
    """Bock-Aitkin MML for grm and gpcm (K = 1): the indicator-matmul
    E-step and m_step_grm, gpcm with its N(0, 1) ridge. "b" holds b_free;
    "kappa" (grm) or "kap" (gpcm) the family's table."""
    fam = cfg.irt_model
    if cfg.ability_dim > 1:
        raise ValueError(f"{fam} EM is K=1 classical (like 1PL/3PL); use "
                         f"VIBO/MLE/HMC for multidimensional {fam}")
    c = cfg.num_categories
    if c < 3:
        raise ValueError(f"{fam} EM needs num_categories >= 3, got {c} "
                         "(binary data is the 1pl/2pl/3pl family)")
    dev = resolve_device(device)
    resp_np = np.asarray(resp, np.float32)
    mask_np = np.asarray(mask, np.float32)
    resp = torch.as_tensor(resp_np, device=dev)
    mask = torch.as_tensor(mask_np, device=dev)
    m = resp.shape[1]
    nodes, w = gauss_hermite_nodes(cfg.num_quadrature, dev)
    log_w = torch.log(w)
    a0 = torch.ones((m,), dtype=torch.float32, device=dev)
    b0 = torch.as_tensor(
        _grm_threshold_init(resp_np, mask_np, c) if fam == "grm"
        else _gpcm_step_init(resp_np, mask_np, c), device=dev)
    prior_var = 1.0 if fam == "gpcm" else None

    def one_iter(params):
        a, b_free = params
        post, ll = e_step_grm(resp, mask, nodes, log_w, a, b_free, c,
                              irt_model=fam)
        n_qjc = torch.stack([post.T @ (mask * (resp == cat))
                             for cat in range(c)], dim=-1)
        with torch.enable_grad():
            params = m_step_grm(n_qjc, nodes, a, b_free, cfg.newton_steps,
                                irt_model=fam, prior_var=prior_var)
        return params, ll

    (a, b_free), iters = _run(one_iter, (a0, b0), cfg)
    post, ll = e_step_grm(resp, mask, nodes, log_w, a, b_free, c,
                          irt_model=fam)
    table_key = "kappa" if fam == "grm" else "kap"
    return {"a": a.cpu().numpy(), "b": b_free.cpu().numpy(),
            table_key: links.categorical_table(fam, b_free).cpu().numpy(),
            "irt_model": fam,
            "theta_eap": (post @ nodes).cpu().numpy(),
            "log_marginal": float(ll), "iterations": iters,
            "num_categories": c, "nodes": nodes.cpu().numpy(),
            "posterior_node_weights": post.cpu().numpy()}


@torch.no_grad()
def response_prob(result: dict, device=None) -> np.ndarray:
    """Posterior-predictive probabilities of an EM fit (fit_em's result,
    or the JAX package's) under each person's node posterior: (N, M)
    success probabilities for the binary links, (N, M, C) category
    probabilities for grm/gpcm."""
    dev = resolve_device(device)

    def item(name):
        return torch.as_tensor(np.asarray(result[name], np.float32),
                               device=dev)

    nodes_t, post = item("nodes"), item("posterior_node_weights")
    fam = result.get("irt_model")
    if fam in ("grm", "gpcm"):
        logp = _categorical_node_logprob(fam, nodes_t, item("a"), item("b"))
        q, m, c = logp.shape
        probs = post @ torch.exp(logp).reshape(q, m * c)
        return probs.reshape(post.shape[0], m, c).cpu().numpy()
    p = _item_prob(nodes_t, item("a"), item("b"),
                   item("g_hat") if "g_hat" in result else None)
    return (post @ p).cpu().numpy()
