"""VIBO training harness (counterpart of `vibo_tpu.train.trainer`). Two
paths, as in JAX: full batch on the int8 code (`step`, the packed ELBO or
IWAE bound), and person minibatches of decoded (response, mask)
(`minibatch_step`, the ELBO or IWAE bound with the item terms scaled by
batch_size / N). A step is the objective with exogenous noise, its
backward, clipping by global norm and Adam.

`fit` runs epochs in chunks of eval_every with one host fetch of the
chunk's per-epoch aux and then the held-out eval. On a full batch with
`fuse_epochs` (the default, as in JAX) a chunk is `make_scan`'s
`FusedSteps`: on the card one CUDA graph of the chunk's steps, replayed
with one launch; on the CPU the same steps eagerly, so the two settings of
fuse_epochs give the same numbers there.

Optimizer parity with the JAX chain `optax.chain(clip_by_global_norm(c),
adam(lr))`:
- clipping scales by c / norm only when norm >= c, with no epsilon
  (`clip_by_global_norm_`); torch.nn.utils.clip_grad_norm_ adds 1e-6 and
  differs;
- torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8) is optax.adam(lr): eps
  is added outside the square root of the bias-corrected second moment and
  both moments are bias-corrected the same way (tests/test_torch_trainer.py
  holds the two against each other; on the card Adam is capturable, its
  step count and bias correction on the device, and chip_smoke.py holds it
  against the plain form).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
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
from vibo_tpu_torch.train import checkpoint as ckpt
from vibo_tpu_torch.utils.metrics import AverageMeter, MetricsLogger

# the per-step aux a chunk returns, in its columns' order
AUX_KEYS = ("elbo", "loglik", "kl_theta", "kl_items")
# eager steps on a side stream before a capture (FusedSteps)
WARMUP_STEPS = 2


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
    fuse_epochs: bool = True           # full batch: each eval interval's
                                       # steps as one FusedSteps call (on
                                       # the card a CUDA graph)
    out_dir: str | None = None         # best.npz + metrics.jsonl
    log_every: int = 10                # epochs between train records
    restarts: int = 1                  # independent fits (seed, seed + 1,
                                       # ...); fit keeps the best final
                                       # training bound
    warm_start: str | None = None      # checkpoint whose params are
                                       # transplanted into the init (a
                                       # narrower family's: zero-filled
                                       # appended slots); Adam starts fresh


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- (g / norm) * max_norm where
    norm >= max_norm, unchanged otherwise. No host sync. Returns the norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """Adam over the param leaves, matching optax.adam(lr) (module doc); on
    the card capturable (its step count and bias correction stay on the
    device), which a CUDA graph of the step needs and the CPU lacks."""
    leaves = tree_leaves(params)
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=leaves[0].is_cuda)


def _snapshot(params: dict, optimizer, generator) -> tuple:
    """Copies of the params, Adam's state (None where it has none yet) and
    the generator's state."""
    leaves = tree_leaves(params)
    return ([p.detach().clone() for p in leaves],
            [{k: v.clone() for k, v in optimizer.state[p].items()}
             if p in optimizer.state else None for p in leaves],
            generator.get_state())


def _restore(saved: tuple, params: dict, optimizer, generator) -> None:
    """Put back what _snapshot saved, in place (the tensors keep their
    addresses); Adam's state made since is zeroed, which is its fresh
    value."""
    values, states, gen_state = saved
    with torch.no_grad():
        for p, v, st in zip(tree_leaves(params), values, states):
            p.copy_(v)
            for k, t in optimizer.state[p].items():
                if st is None:
                    t.zero_()
                else:
                    t.copy_(st[k])
    generator.set_state(gen_state)


class FusedSteps:
    """`length` packed full-batch steps (noise, forward, backward, clip,
    Adam) as one call, the counterpart of JAX's `make_scan`: called as
    (params, optimizer, packed, row_valid, generator), it trains the params
    in place and returns the steps' aux (length, 4) on the device, columns
    AUX_KEYS.

    On the card the first call captures the `length` steps in one
    torch.cuda.CUDAGraph and every call replays it: one launch a chunk and
    no host sync inside it. Capture bakes in the addresses of all the graph
    reads and writes (the params, Adam's state, the code and row_valid, the
    scratch of every kernel and the first layer's TMA descriptors built
    from them), so a later call must pass the same objects. Before the
    capture WARMUP_STEPS eager steps run on a side stream (they bind every
    kernel library, fill the host-side plans, make Adam's state and the
    cuBLAS workspace) and the params, Adam's state and the generator are
    then put back as they were, so the graph's first step is the one an
    eager step would take. The generator is registered with the graph:
    each replay draws fresh noise from it and moves it on as that many
    eager steps would. A failed capture or replay raises; nothing falls
    back to eager steps.

    On the CPU a call runs the same steps eagerly, drawing from the
    generator in the same order.

    `noise` holds each step's (item_eps, theta_eps) of the last call; on
    the card they are the graph's static buffers, which each replay
    overwrites."""

    def __init__(self, trainer: "Trainer", item_scale: float,
                 num_samples: int, length: int):
        self.trainer, self.item_scale = trainer, item_scale
        self.num_samples, self.length = num_samples, length
        self.graph = None
        self.noise: list = []
        self._inputs: tuple = ()
        self._aux = None

    def _step(self, params, optimizer, packed, row_valid, generator):
        """One step; returns its noise and its aux row (4,)."""
        noise = self.trainer.packed_noise(packed, self.num_samples,
                                          generator)
        aux = self.trainer.step_with_noise(params, optimizer, packed,
                                           row_valid, *noise,
                                           self.item_scale)
        return noise, torch.stack([aux[k] for k in AUX_KEYS])

    def _steps(self, *args):
        rows, self.noise = [], []
        for _ in range(self.length):
            noise, row = self._step(*args)
            self.noise.append(noise)
            rows.append(row)
        return torch.stack(rows)

    def _capture(self, args: tuple) -> None:
        params, optimizer, packed, _, generator = args
        dev = packed.device
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state); the fused steps need "
                "it to draw their noise inside the graph")
        saved = _snapshot(params, optimizer, generator)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        _restore(saved, params, optimizer, generator)
        graph.register_generator_state(generator)
        optimizer.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            self._aux = self._steps(*args)
        self.graph = graph

    def __call__(self, params: dict, optimizer, packed, row_valid,
                 generator: torch.Generator) -> torch.Tensor:
        args = (params, optimizer, packed, row_valid, generator)
        if not packed.is_cuda:
            return self._steps(*args)
        inputs = (*tree_leaves(params), optimizer, packed, row_valid,
                  generator)
        if self.graph is None:
            self._inputs = inputs
            self._capture(args)
        elif (len(inputs) != len(self._inputs)
              or any(a is not b for a, b in zip(inputs, self._inputs))):
            raise ValueError("a captured FusedSteps replays on the params, "
                             "optimizer, code, row_valid and generator it "
                             "was captured with")
        self.graph.replay()
        return self._aux.clone()


class Trainer:
    def __init__(self, model: VIBO, cfg: TrainConfig, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, trainer on "
                             f"{self.device}")
        if cfg.objective not in ("elbo", "iwae"):
            raise ValueError(f"objective must be elbo|iwae, got "
                             f"{cfg.objective!r}")
        if cfg.restarts < 1:
            raise ValueError(f"restarts must be >= 1, got {cfg.restarts}")
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

    def _bound_update(self, params: dict, optimizer, out) -> dict:
        """_update on an objective's output: the ELBO's (bound, aux), or the
        IWAE bound, logged as 'elbo' and 'loglik' with zeroed KL fields (as
        in JAX)."""
        if self.cfg.objective == "elbo":
            return self._update(params, optimizer, *out)
        zero = torch.zeros((), device=out.device)
        return self._update(params, optimizer, out,
                            {"elbo": out, "loglik": out, "kl_theta": zero,
                             "kl_items": zero})

    def packed_noise(self, packed, num_samples: int,
                     generator: torch.Generator):
        """sample_noise for the packed step: theta eps in the layout the
        link's step runs (wants_transposed_theta)."""
        return self.model.sample_noise(
            packed.shape[0], num_samples,
            transposed=self.model.wants_transposed_theta(),
            generator=generator)

    def step_with_noise(self, params: dict, optimizer, packed, row_valid,
                        item_eps: dict, theta_eps, item_scale: float = 1.0):
        """One packed full-batch step of cfg.objective on given noise (the
        JAX `_packed_raw_step`): the ELBO, or the IWAE bound of the noise's
        S samples, item terms scaled by item_scale."""
        model = self.model
        tp = model.wants_transposed_theta()
        if self.cfg.objective == "elbo":
            ll, klt, kli = model.elbo_packed_sums(
                params, packed, item_eps, theta_eps, row_valid,
                transposed=tp)
            bound = objectives.elbo(ll, klt, kli, item_scale)
            out = bound, {"elbo": bound, "loglik": ll, "kl_theta": klt,
                          "kl_items": kli}
        else:
            local, ratio = model.iwae_packed_terms(
                params, packed, item_eps, theta_eps, row_valid,
                transposed=tp)
            out = objectives.iwae_bound(local + item_scale * ratio)
        return self._bound_update(params, optimizer, out)

    def step(self, params: dict, optimizer, packed, row_valid,
             generator: torch.Generator):
        """One packed full-batch step with cfg.num_mc_samples draws of
        noise from `generator`."""
        return self.step_with_noise(
            params, optimizer, packed, row_valid,
            *self.packed_noise(packed, self.cfg.num_mc_samples, generator))

    def make_scan(self, item_scale: float, num_samples: int,
                  length: int) -> FusedSteps:
        """`length` packed full-batch steps as one call (JAX `make_scan`;
        FusedSteps: a CUDA graph on the card)."""
        return FusedSteps(self, item_scale, num_samples, length)

    def minibatch_step_with_noise(self, params: dict, optimizer, response,
                                  mask, item_eps: dict, theta_eps,
                                  item_scale: float):
        """One step on a decoded (response, mask) minibatch and given noise
        (the counterpart of the JAX `make_step`): cfg.objective with the
        item terms scaled by item_scale."""
        core = (self.model.elbo_eps if self.cfg.objective == "elbo"
                else self.model.iwae_eps)
        return self._bound_update(params, optimizer, core(
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
        return self._bound_update(params, optimizer, out)

    def _cfg_json(self) -> str:
        """The model config as JSON, embedded in checkpoints so they are
        self-describing (AbilityScorer.from_checkpoint needs no model)."""
        return json.dumps(dataclasses.asdict(self.model.cfg))

    def _opt_cfg_json(self) -> str:
        """The optimizer config embedded in checkpoints."""
        return json.dumps({"lr": self.cfg.lr,
                           "max_grad_norm": self.cfg.max_grad_norm})

    @staticmethod
    def _vocab_extra(ds) -> dict:
        """The item-id vocabulary for the checkpoint, where the dataset
        carries one."""
        if getattr(ds, "item_ids", None) is None:
            return {}
        return {"item_ids": json.dumps(list(map(str, ds.item_ids)))}

    def fit(self, ds: Dataset, truth=None, resume: str | None = None) -> dict:
        """Train on ds.train_mask: full batch on the int8 code, or person
        minibatches of cfg.batch_size decoded rows (batch_iterator, the last
        one zero-padded), in chunks of eval_every epochs, each ended by one
        host fetch of its per-epoch aux, the check_finite check and the
        held-out imputation accuracy. A full-batch chunk is one make_scan
        call under fuse_epochs (a new FusedSteps each fit, on this fit's
        objects), else one step an epoch.

        truth: a SyntheticIRT whose theta gives each eval record its
        theta_pearson. resume: a checkpoint of this package
        (train/checkpoint.py) whose params, Adam state and generator state
        are restored, then cfg.epochs FURTHER epochs trained (bitwise the
        same as one uninterrupted fit). cfg.warm_start: a checkpoint of
        either package whose params are transplanted into the fresh init
        (check_transplant_compat, transplant_params); Adam starts fresh.
        cfg.out_dir: metrics.jsonl (every record of the history) and
        best.npz at each new best held-out accuracy. cfg.restarts > 1: that
        many fits from seeds seed, seed + 1, ..., the best final training
        bound kept.

        Returns params, optimizer, generator, history (a train record every
        log_every epochs and at the last, its ELBO the mean over the
        epoch's steps; an eval record each chunk), best accuracy, final
        ELBO (the last epoch's), train seconds, warm train seconds (the
        first chunk, which captures the graph, counted at the median of the
        others, as in JAX) and throughput in true response cells (N * M an
        epoch, padding not counted) per second."""
        if self.cfg.restarts > 1:
            return self._fit_restarts(ds, truth, resume)
        return self._fit_single(ds, truth, resume)

    def _fit_restarts(self, ds: Dataset, truth, resume) -> dict:
        """cfg.restarts independent fits (seed + r, under out_dir/restart{r});
        the best FINAL training bound wins (held-out data never selects),
        and its best.npz is promoted to out_dir."""
        if resume:
            raise ValueError(
                "restarts > 1 cannot be combined with resume=; resume the "
                "selected run's checkpoint with restarts=1")
        base = self.cfg
        runs = []
        for r in range(base.restarts):
            sub_cfg = dataclasses.replace(
                base, restarts=1, seed=base.seed + r,
                out_dir=(os.path.join(base.out_dir, f"restart{r}")
                         if base.out_dir else None))
            runs.append(Trainer(self.model, sub_cfg, device=self.device
                                )._fit_single(ds, truth, None))
        scores = np.asarray([run["final_elbo"] for run in runs], np.float64)
        selected = 0 if np.all(np.isnan(scores)) else int(np.nanargmax(scores))
        res = runs[selected]
        res["selected_restart"] = selected
        res["restarts"] = [
            {"restart": r, "seed": base.seed + r,
             "final_elbo": run["final_elbo"],
             "best_heldout_acc": run["best"]["heldout_acc"]}
            for r, run in enumerate(runs)]
        if base.out_dir:
            src = os.path.join(base.out_dir, f"restart{selected}", "best.npz")
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(base.out_dir, "best.npz"))
        return res

    def _fit_single(self, ds: Dataset, truth, resume) -> dict:
        cfg = self.cfg
        n, m = ds.response.shape
        batch_size = min(cfg.batch_size or n, n)
        item_scale = batch_size / n
        full_batch = batch_size >= n      # trains on the int8 code
        steps_per_epoch = 1 if full_batch else -(-n // batch_size)
        dev = self.device
        if cfg.warm_start and resume:
            raise ValueError("warm_start and resume are mutually exclusive: "
                             "resume restores exact state; warm_start "
                             "transplants params into a fresh run")
        if full_batch:
            packed, row_valid = packed_on_device(ds.response, ds.train_mask,
                                                 dev)
        params = self.model.init_params(cfg.seed)
        if cfg.warm_start:
            extra = ckpt.peek_extra(cfg.warm_start)
            if "model_cfg" in extra:
                ckpt.check_transplant_compat(
                    json.loads(str(extra["model_cfg"])), self.model.cfg)
            params = ckpt.transplant_params(
                ckpt.load_params_self_describing(cfg.warm_start, dev), params)
        optimizer = make_optimizer(params, cfg.lr)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed + 1)
        if resume:
            state, gen_state, _, _ = ckpt.load_checkpoint(
                resume, ckpt.train_state(params, optimizer))
            ckpt.restore_train_state(state, params, optimizer)
            gen.set_state(gen_state)
        if cfg.out_dir:
            os.makedirs(cfg.out_dir, exist_ok=True)
        logger = MetricsLogger(os.path.join(cfg.out_dir, "metrics.jsonl")
                               if cfg.out_dir else None)

        def run_epoch(epoch: int):
            """One epoch's steps -> its aux row (the ELBO's mean over the
            steps, the last step's other terms)."""
            if full_batch:
                aux = self.step(params, optimizer, packed, row_valid, gen)
                elbos = [aux["elbo"]]
            else:
                elbos = []
                for resp, mask in batch_iterator(ds, batch_size, cfg.seed,
                                                 epoch):
                    aux = self.minibatch_step(
                        params, optimizer, torch.from_numpy(resp).to(dev),
                        torch.from_numpy(mask).to(dev), item_scale, gen)
                    elbos.append(aux["elbo"])
            return torch.stack([torch.stack(elbos).mean(),
                                *(aux[k] for k in AUX_KEYS[1:])])

        scans = {}

        def run_chunk(first: int, length: int):
            if not (full_batch and cfg.fuse_epochs):
                return torch.stack([run_epoch(e)
                                    for e in range(first, first + length)])
            if length not in scans:
                scans[length] = self.make_scan(item_scale,
                                               cfg.num_mc_samples, length)
            return scans[length](params, optimizer, packed, row_valid, gen)

        def log(rec: dict) -> None:
            logger.log(**rec)
            history.append(rec)

        chunk = max(1, min(cfg.eval_every, cfg.epochs))
        history, chunk_dts = [], []
        cells = AverageMeter()
        final_elbo = float("nan")
        best = {"heldout_acc": -1.0, "epoch": -1}
        epoch = 0
        while epoch < cfg.epochs:
            n_run = min(chunk, cfg.epochs - epoch)
            t0 = time.perf_counter()
            auxs = run_chunk(epoch, n_run).cpu().numpy()  # completion barrier
            chunk_dts.append(time.perf_counter() - t0)
            cells.update(n * m * n_run / chunk_dts[-1])
            elbos = auxs[:, 0]
            if cfg.check_finite and not np.isfinite(elbos).all():
                bad = int(np.argmax(~np.isfinite(elbos)))
                raise FloatingPointError(
                    f"non-finite ELBO at epoch {epoch + bad}: "
                    f"loglik={float(auxs[bad, 1])} "
                    f"kl_theta={float(auxs[bad, 2])} "
                    f"kl_items={float(auxs[bad, 3])} — check lr/grad-clip")
            for i, row in enumerate(auxs):
                e = epoch + i
                if (e + 1) % cfg.log_every == 0 or e == cfg.epochs - 1:
                    log({"event": "train", "epoch": e,
                         "step": (e + 1) * steps_per_epoch,
                         **{k: float(v) for k, v in zip(AUX_KEYS, row)},
                         "cells_per_sec": cells.avg})
            epoch += n_run
            final_elbo = float(elbos[-1])
            if ds.heldout_mask.sum() > 0:
                ev = evaluation.imputation_accuracy(self.model, params, ds)
                rec = {"event": "eval", "epoch": epoch - 1, **ev}
                if truth is not None:
                    theta_hat, _ = evaluation.infer_posterior_means(
                        self.model, params, ds)
                    rec["theta_pearson"] = evaluation.correlation(
                        theta_hat[:truth.theta.shape[0]], truth.theta,
                        align_rotation=True)["pearson"]
                log(rec)
                if ev["acc"] > best["heldout_acc"]:
                    best = {"heldout_acc": ev["acc"], "epoch": epoch - 1}
                    if cfg.out_dir:
                        ckpt.save_checkpoint(
                            os.path.join(cfg.out_dir, "best.npz"),
                            ckpt.train_state(params, optimizer), gen,
                            epoch * steps_per_epoch,
                            extra={"epoch": epoch - 1,
                                   "heldout_acc": ev["acc"],
                                   "model_cfg": self._cfg_json(),
                                   "opt_cfg": self._opt_cfg_json(),
                                   **self._vocab_extra(ds)})
        logger.close()
        t_train = sum(chunk_dts)
        warm = (t_train - chunk_dts[0] + float(np.median(chunk_dts[1:]))
                if len(chunk_dts) > 1 else t_train)
        return {"params": params, "optimizer": optimizer, "generator": gen,
                "history": history, "best": best, "final_elbo": final_elbo,
                "train_seconds": t_train, "warm_train_seconds": warm,
                "cells_per_sec": n * m * cfg.epochs / t_train}
