"""Serving API: amortized ability scoring for new students and cold-start
scoring of new items (counterpart of `vibo_tpu.serve.AbilityScorer`:
score, laplace_sigma, refine, score_items, from_checkpoint).

    scorer = AbilityScorer(model, params)
    out = scorer.score(responses, masks)     # (B, M) float arrays
    out["theta_mu"]          # (B, K) posterior ability means
    out["theta_sigma"]       # (B, K) posterior std devs
    out["prob"]              # (B, M) predicted correctness probabilities
                             # (deep: through the link MLP);
                             # grm/gpcm: (B, M, C) category probabilities

    scorer.laplace_sigma(responses, masks)  # (B, K) Fisher widths
    scorer.refine(responses, masks, steps=50)  # per-person SVI of q(theta)
    scorer.score_items(responses, masks)   # new items' posteriors (the
                                           # item encoder's cold start)

    scorer = AbilityScorer.from_checkpoint("runs/pisa/best.npz")

loads a Trainer checkpoint of this package or of the JAX package by its
embedded model config.
"""

from __future__ import annotations

import numpy as np
import torch

from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.convert import tree_map
from vibo_tpu_torch.models.vibo import VIBO
from vibo_tpu_torch.ops import distributions as dist
from vibo_tpu_torch.ops.links import CATEGORICAL_MODELS
from vibo_tpu_torch.train import checkpoint as ckpt


class AbilityScorer:
    """Deterministic batched inference: the item-posterior MEANS condition
    the encoder (no sampling). Batches are zero-padded to `pad_multiple`
    rows, as in the JAX scorer, so the device sees few distinct shapes.
    item_mean: frozen item means (e.g. evaluation.full_item_mean of the
    training matrix); without them an amortized item posterior
    (item_encoder) conditions on each scoring batch's own columns, as in
    JAX. theta_sigma is the marginal sd of every posterior family."""

    def __init__(self, model: VIBO, params: dict, pad_multiple: int = 256,
                 item_mean: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.detach().to(self.device), params)
        self.pad_multiple = max(1, pad_multiple)
        self.item_mean = (None if item_mean is None else
                          {k: torch.as_tensor(v, dtype=torch.float32,
                                              device=self.device)
                           for k, v in item_mean.items()})

    @classmethod
    def from_checkpoint(cls, path: str, model: VIBO | None = None,
                        device=None, **kw) -> "AbilityScorer":
        """A scorer of the params in a Trainer checkpoint (train/checkpoint.py;
        the JAX package's Trainer checkpoints too, by their params). model:
        optional; by default rebuilt from the embedded model config on
        `device` (None: the card; with a model given, the model's).
        kw: AbilityScorer's own (pad_multiple, item_mean)."""
        if model is None:
            extra = ckpt.peek_extra(path)
            if "model_cfg" not in extra:
                raise ValueError(
                    f"{path} has no embedded model config; pass model=")
            model = VIBO(ckpt.config_from_json(extra["model_cfg"]),
                         device=device)
        return cls(model, ckpt.load_params(path, model),
                   device=model.device if device is None else device, **kw)

    @torch.no_grad()
    def score(self, response, mask) -> dict:
        """response/mask: (B, M) arrays -> dict of numpy (see module doc).
        mask marks the observed cells; `prob` predicts every cell."""
        response = np.asarray(response, np.float32)
        mask = np.asarray(mask, np.float32)
        if response.ndim != 2 or response.shape != mask.shape:
            raise ValueError(
                f"expected matching (B, M) response/mask, got "
                f"{response.shape} vs {mask.shape}")
        b = response.shape[0]
        pad = (-b) % self.pad_multiple
        if pad:
            response = np.pad(response, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
        resp_t = torch.from_numpy(response).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        item_mean = self._item_means(resp_t, mask_t)
        mu, logvar, off = self.model.encode(self.params, resp_t, mask_t,
                                            item_mean)
        if self.model.cfg.irt_model in CATEGORICAL_MODELS:
            prob = torch.exp(self.model.category_logprobs(self.params, mu,
                                                          item_mean))
        else:
            prob = self.model.response_prob(self.params, mu, item_mean)
        sigma = dist.tril_marginal_sigma(logvar, off)
        return {"theta_mu": mu.cpu().numpy()[:b],
                "theta_sigma": sigma.cpu().numpy()[:b],
                "prob": prob.cpu().numpy()[:b]}

    def _item_means(self, response, mask) -> dict:
        """The item means the scorer conditions on (detached tensors): the
        frozen ones, else the posterior's (an amortized one's on this
        (response, mask) batch)."""
        items = (self.item_mean if self.item_mean is not None
                 else self.model.item_posterior_mean(self.params, response,
                                                     mask))
        return {k: v.detach() for k, v in items.items()}

    def _tensors(self, response, mask):
        return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(
            self.device) for x in (response, mask))

    def laplace_sigma(self, response, mask, theta_mu=None) -> np.ndarray:
        """(B, K) Laplace (Fisher) posterior widths at the amortized mean:
        closed form for the linear and polytomous links, the Gauss-Newton
        information through the link's Jacobian for the deep link
        (evaluation.laplace_theta_sigma). theta_mu defaults to score()'s."""
        from vibo_tpu_torch import evaluation
        if theta_mu is None:
            theta_mu = self.score(response, mask)["theta_mu"]
        with torch.no_grad():
            items = {k: v.cpu().numpy() for k, v in
                     self._item_means(*self._tensors(response, mask)).items()}
        if self.model.cfg.irt_model == "deep":
            return evaluation.laplace_sigma_deep(
                self.params["deep_link"], items["d"], mask, theta_mu,
                device=self.device)
        return evaluation.laplace_sigma_from_items(
            items, self.model.cfg.irt_model, mask, theta_mu)

    def refine(self, response, mask, steps: int = 300, lr: float = 0.05,
               num_samples: int = 8, seed: int = 0,
               noise: tuple | None = None) -> dict:
        """Semi-amortized scoring: per-person SVI refinement of q(theta)
        from the amortized posterior (evaluation.refine_block), the batch
        zero-padded to pad_multiple rows as in score. The serving arrays go
        through the evaluation's bit-code (binary: bit 0 the response, bit
        1 the mask; polytomous: bits 0-4 the category, bit 5 the mask) and
        back, as the JAX scorer feeds its refinement. noise: (step_eps
        (steps, S, rows, K), eval_eps (S, rows, K)) for the padded rows,
        else draws from a generator seeded with `seed` on the scorer's
        device. Returns {"theta_mu", "theta_sigma", "theta_tril",
        "elbo_gain_per_person"}."""
        from vibo_tpu_torch import evaluation
        response = np.asarray(response, np.float32)
        mask = np.asarray(mask, np.float32)
        if response.ndim != 2 or response.shape != mask.shape:
            raise ValueError(
                f"expected matching (B, M) response/mask, got "
                f"{response.shape} vs {mask.shape}")
        b = response.shape[0]
        pad = (-b) % self.pad_multiple
        if pad:
            response = np.pad(response, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
        if self.model.cfg.num_categories > 2:
            code = (response.astype(np.uint8) & 31) \
                | ((mask > 0).astype(np.uint8) << 5)
            resp_c, mask_c = code & 31, (code >> 5) & 1
        else:
            code = (response.astype(np.uint8) & 1) \
                | ((mask > 0).astype(np.uint8) << 1)
            resp_c, mask_c = code & 1, (code >> 1) & 1
        dev = self.device
        with torch.no_grad():
            resp_t, mask_t = self._tensors(response, mask)
            items = self._item_means(resp_t, mask_t)
            mu0, logvar0, off0 = self.model.encode(self.params, resp_t,
                                                   mask_t, items)
        resp_c, mask_c = self._tensors(resp_c, mask_c)
        deep = (self.params["deep_link"]
                if self.model.cfg.irt_model == "deep" else None)
        generator = (None if noise is not None
                     else torch.Generator(device=dev).manual_seed(seed))
        mu, sigma, tril, per0, per1 = evaluation.refine_block(
            self.model.cfg.irt_model, items, deep, resp_c, mask_c, mu0,
            logvar0, steps, lr, num_samples, noise, generator, off0)
        gain = (per1 - per0).cpu().numpy()[:b].mean()
        return {"theta_mu": mu.cpu().numpy()[:b],
                "theta_sigma": sigma.cpu().numpy()[:b],
                "theta_tril": tril.cpu().numpy()[:b],
                "elbo_gain_per_person": float(gain)}

    @torch.no_grad()
    def score_items(self, response, mask) -> dict:
        """New-item cold start: the item encoder alone (no residuals) infers
        the posteriors of unseen items from their response columns in one
        pass. response/mask: (B, M_new), rows any respondents, columns the
        new items. Returns {"<param>_mu": (M_new, D), "<param>_sigma":
        (M_new, D)} for each item parameter (a, b, ...). Needs a model
        trained with item_encoder=True."""
        if not self.model.cfg.item_encoder:
            raise ValueError(
                "score_items needs an amortized item posterior: train with "
                "VIBOConfig(item_encoder=True); the free-form per-item "
                "posterior cannot score unseen items")
        response = np.asarray(response, np.float32)
        mask = np.asarray(mask, np.float32)
        if response.ndim != 2 or response.shape != mask.shape:
            raise ValueError(
                f"expected matching (B, M_new) response/mask, got "
                f"{response.shape} vs {mask.shape}")
        post = self.model.item_dist(self.params,
                                    *self._tensors(response, mask),
                                    new_items=True)
        out = {}
        for name, p in post.items():
            out[f"{name}_mu"] = p["mu"].cpu().numpy()
            out[f"{name}_sigma"] = torch.exp(0.5 * p["logvar"]).cpu().numpy()
        return out
