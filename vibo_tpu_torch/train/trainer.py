"""VIBO training harness (counterpart of `vibo_tpu.train.trainer`). Two
paths, as in JAX: full batch on the int8 code (`step`, the packed ELBO), and
person minibatches of decoded (response, mask) (`minibatch_step`, the ELBO
or IWAE bound with the item terms scaled by batch_size / N). A step is the
objective with exogenous noise, its backward, clipping by global norm and
Adam.

Optimizer parity with the JAX chain `optax.chain(clip_by_global_norm(c),
adam(lr))`:
- clipping scales by c / norm only when norm >= c, with no epsilon
  (`clip_by_global_norm_`); torch.nn.utils.clip_grad_norm_ adds 1e-6 and
  differs;
- torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8) is optax.adam(lr): eps
  is added outside the square root of the bias-corrected second moment and
  both moments are bias-corrected the same way (tests/test_torch_trainer.py
  holds the two against each other).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vibo_tpu_torch import evaluation
from vibo_tpu_torch._device import resolve_device
from vibo_tpu_torch.convert import tree_leaves
from vibo_tpu_torch.data.masking import Dataset, batch_iterator
from vibo_tpu_torch.models.vibo import VIBO
from vibo_tpu_torch.ops import objectives
from vibo_tpu_torch.ops.packing import packed_on_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-3
    epochs: int = 50
    batch_size: int | None = None      # None => full batch
    num_mc_samples: int = 1            # S for the training objective
    seed: int = 0
    eval_every: int = 10               # epochs between held-out evals
    max_grad_norm: float | None = 10.0
    check_finite: bool = True          # raise on a NaN/Inf ELBO
    objective: str = "elbo"            # "elbo" | "iwae" (S samples)


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- (g / norm) * max_norm where
    norm >= max_norm, unchanged otherwise. No host sync. Returns the norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """Adam over the param leaves, matching optax.adam(lr) (module doc)."""
    return torch.optim.Adam(tree_leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


class Trainer:
    def __init__(self, model: VIBO, cfg: TrainConfig, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, trainer on "
                             f"{self.device}")
        if cfg.objective not in ("elbo", "iwae"):
            raise ValueError(f"objective must be elbo|iwae, got "
                             f"{cfg.objective!r}")
        self.model = model
        self.cfg = cfg

    def _update(self, params: dict, optimizer, bound, aux: dict) -> dict:
        """Ascend `bound`: backward, clip, Adam; params update in place.
        Returns aux detached (0-d tensors, no host sync)."""
        optimizer.zero_grad(set_to_none=True)
        (-bound).backward()
        if self.cfg.max_grad_norm is not None:
            with torch.no_grad():
                clip_by_global_norm_([p.grad for p in tree_leaves(params)],
                                     self.cfg.max_grad_norm)
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    def step_with_noise(self, params: dict, optimizer, packed, row_valid,
                        item_eps: dict, theta_eps):
        """One packed full-batch ELBO step on given noise."""
        if self.cfg.objective != "elbo":
            raise NotImplementedError(
                "IWAE training on the int8 code comes with ROADMAP's "
                "'Trainer and checkpoint, the rest'; "
                "set batch_size to train it on decoded minibatches")
        model = self.model
        ll, klt, kli = model.elbo_packed_sums(
            params, packed, item_eps, theta_eps, row_valid,
            transposed=model.wants_transposed_theta())
        bound = objectives.elbo(ll, klt, kli)   # full batch: item_scale 1
        return self._update(params, optimizer, bound,
                            {"elbo": bound, "loglik": ll, "kl_theta": klt,
                             "kl_items": kli})

    def step(self, params: dict, optimizer, packed, row_valid,
             generator: torch.Generator):
        """One packed full-batch step with noise drawn from `generator`."""
        item_eps, theta_eps = self.model.sample_noise(
            packed.shape[0], self.cfg.num_mc_samples,
            transposed=self.model.wants_transposed_theta(),
            generator=generator)
        return self.step_with_noise(params, optimizer, packed, row_valid,
                                    item_eps, theta_eps)

    def _minibatch_update(self, params: dict, optimizer, out) -> dict:
        """_update on a minibatch objective's output: the ELBO's (bound,
        aux), or the IWAE bound, logged as 'elbo' with zeroed KL fields."""
        if self.cfg.objective == "elbo":
            return self._update(params, optimizer, *out)
        zero = torch.zeros((), device=out.device)
        return self._update(params, optimizer, out,
                            {"elbo": out, "loglik": out, "kl_theta": zero,
                             "kl_items": zero})

    def minibatch_step_with_noise(self, params: dict, optimizer, response,
                                  mask, item_eps: dict, theta_eps,
                                  item_scale: float):
        """One step on a decoded (response, mask) minibatch and given noise
        (the counterpart of the JAX `make_step`): cfg.objective with the
        item terms scaled by item_scale."""
        core = (self.model.elbo_eps if self.cfg.objective == "elbo"
                else self.model.iwae_eps)
        return self._minibatch_update(params, optimizer, core(
            params, response, mask, item_eps, theta_eps, item_scale))

    def minibatch_step(self, params: dict, optimizer, response, mask,
                       item_scale: float, generator: torch.Generator):
        """minibatch_step_with_noise with cfg.num_mc_samples draws of noise
        from `generator` (VIBO.elbo / VIBO.iwae)."""
        model, s = self.model, self.cfg.num_mc_samples
        if self.cfg.objective == "elbo":
            out = model.elbo(params, response, mask, item_scale, s, generator)
        else:
            out = model.iwae(params, response, mask, s, item_scale, generator)
        return self._minibatch_update(params, optimizer, out)

    def fit(self, ds: Dataset) -> dict:
        """Train on ds.train_mask: full batch on the int8 code, or person
        minibatches of cfg.batch_size decoded rows (batch_iterator, the last
        one zero-padded), with held-out imputation accuracy every
        eval_every epochs. Returns params, optimizer, history (one train
        record per epoch, its ELBO the mean over the epoch's steps), best
        accuracy, final ELBO (the last epoch's mean) and throughput in true
        response cells (N * M an epoch, padding not counted) per second."""
        cfg = self.cfg
        n, m = ds.response.shape
        batch_size = min(cfg.batch_size or n, n)
        item_scale = batch_size / n
        full_batch = batch_size >= n      # trains on the int8 code
        dev = self.device
        if full_batch:
            packed, row_valid = packed_on_device(ds.response, ds.train_mask,
                                                 dev)
        params = self.model.init_params(cfg.seed)
        optimizer = make_optimizer(params, cfg.lr)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed + 1)

        def run_epoch(epoch: int):
            if full_batch:
                aux = self.step(params, optimizer, packed, row_valid, gen)
                return aux, [aux["elbo"]]
            elbos = []
            for resp, mask in batch_iterator(ds, batch_size, cfg.seed, epoch):
                aux = self.minibatch_step(
                    params, optimizer, torch.from_numpy(resp).to(dev),
                    torch.from_numpy(mask).to(dev), item_scale, gen)
                elbos.append(aux["elbo"])
            return aux, elbos

        history, epoch_elbos = [], []
        final_elbo = float("nan")
        best = {"heldout_acc": -1.0, "epoch": -1}
        t_train = 0.0
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            aux, elbos = run_epoch(epoch)
            epoch_elbos.append(torch.stack(elbos).mean())
            last = epoch == cfg.epochs - 1
            if (epoch + 1) % cfg.eval_every and not last:
                t_train += time.perf_counter() - t0
                continue
            # completion barrier
            chunk = torch.stack(epoch_elbos).cpu().numpy()
            t_train += time.perf_counter() - t0
            epoch_elbos = []
            if cfg.check_finite and not np.isfinite(chunk).all():
                raise FloatingPointError(
                    f"non-finite ELBO by epoch {epoch}: loglik="
                    f"{float(aux['loglik'])} kl_theta="
                    f"{float(aux['kl_theta'])} kl_items="
                    f"{float(aux['kl_items'])}; check lr/grad-clip")
            final_elbo = float(chunk[-1])
            first = epoch + 1 - len(chunk)
            history.extend({"event": "train", "epoch": first + i,
                            "elbo": float(v)} for i, v in enumerate(chunk))
            if ds.heldout_mask.sum() > 0:
                ev = evaluation.imputation_accuracy(self.model, params, ds)
                history.append({"event": "eval", "epoch": epoch, **ev})
                if ev["acc"] > best["heldout_acc"]:
                    best = {"heldout_acc": ev["acc"], "epoch": epoch}
        return {"params": params, "optimizer": optimizer,
                "history": history, "best": best, "final_elbo": final_elbo,
                "train_seconds": t_train,
                "cells_per_sec": n * m * cfg.epochs / t_train}
