"""Serving API: amortized ability scoring for new students (counterpart of
`vibo_tpu.serve.AbilityScorer.score`).

    scorer = AbilityScorer(model, params)
    out = scorer.score(responses, masks)     # (B, M) float arrays
    out["theta_mu"]          # (B, K) posterior ability means
    out["theta_sigma"]       # (B, K) posterior std devs
    out["prob"]              # (B, M) predicted correctness probabilities
                             # (deep: through the link MLP);
                             # grm/gpcm: (B, M, C) category probabilities

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
    rows, as in the JAX scorer, so the device sees few distinct shapes."""

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
        item_mean = (self.item_mean if self.item_mean is not None
                     else self.model.item_posterior_mean(self.params))
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
