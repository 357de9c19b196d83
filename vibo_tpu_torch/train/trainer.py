"""VIBO training harness (counterpart of `vibo_tpu.train.trainer`). Three
paths, as in JAX: full batch on the int8 code (`step`, the packed ELBO or
IWAE bound), full batch on the decoded (response, mask) (TrainConfig.
packed=False: `minibatch_step` on the whole data, item_scale 1), and person
minibatches of decoded (response, mask) (`minibatch_step`, the item terms
scaled by batch_size / N). A step is the objective with exogenous noise,
its backward, clipping by global norm and Adam.

`fit` runs epochs in chunks of eval_every with one host fetch of the
chunk's per-epoch aux and then the held-out eval. On a full batch with
`fuse_epochs` (the default, as in JAX) a chunk is `make_scan`'s
`FusedSteps`: on the card one CUDA graph of the chunk's steps (the code's
or the decoded data's), replayed with one launch; on the CPU the same
steps eagerly, so the two settings of fuse_epochs give the same numbers
there.

On a mesh (`Trainer(..., mesh=parallel.make_mesh(...))`, one process a
rank of a torch.distributed world) the packed full batch runs JAX's
shard_map steps: students only (`_dp_raw_step`: each rank its student rows
of the code) or 2D (`_dp2d_raw_step`: each rank its (students, items)
tile, the encoder's first layer as partial products summed over the items
group); the decoded full batch and the minibatches run as JAX's GSPMD
steps do: each rank its student rows of the batch, the item axis
replicated. Every rank draws the whole noise from the same generator state
(sample_noise on the global row count; a mesh's padding rows get zero
noise) and takes its rows (and item block), so the result does not depend
on the device count. Each rank's loss is its share of the global loss and
every collective of the forward is `parallel.psum`, so summing the
gradients over the mesh once after the backward gives the global gradient
(JAX's comment at `_dp_raw_step`: an extra sum scales it by the shard
count, which Adam's scale invariance hides); clip and Adam then run
identically on every rank. A fused chunk on a mesh runs its steps eagerly
on every rank, with one host fetch a chunk (capturing the collectives in
the graph is a later speed item).

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
import torch.nn.functional as F

from vibo_tpu_torch import evaluation
from vibo_tpu_torch._device import resolve_device, same_device
from vibo_tpu_torch.convert import tree_leaves
from vibo_tpu_torch.data.masking import Dataset, batch_iterator
from vibo_tpu_torch.models.vibo import VIBO
from vibo_tpu_torch.ops import objectives
from vibo_tpu_torch.ops.packing import pack_responses, packed_on_device
from vibo_tpu_torch.parallel import mesh as meshlib
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
    packed: bool | None = None         # full batch on the int8 code (None
                                       # = auto: every full batch, unless
                                       # an item-sharded mesh's items do
                                       # not divide; False: the decoded
                                       # (response, mask))
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
    """`length` full-batch steps (noise, forward, backward, clip, Adam) as
    one call, the counterpart of JAX's `make_scan`: called as (params,
    optimizer, packed, row_valid, generator), or (params, optimizer,
    response, mask, generator) for the decoded full batch (`decoded`), it
    trains the params in place and returns the steps' aux (length, 4) on
    the device, columns AUX_KEYS. `rows`: the data's global row count on a
    mesh (Trainer.packed_noise).

    On the card the first call captures the `length` steps in one
    torch.cuda.CUDAGraph and every call replays it: one launch a chunk and
    no host sync inside it. Capture bakes in the addresses of all the graph
    reads and writes (the params, Adam's state, the data, the scratch of
    every kernel and the first layer's TMA descriptors built from them),
    so a later call must pass the same objects. Before the capture
    WARMUP_STEPS eager steps run on a side stream (they bind every kernel
    library, fill the host-side plans, make Adam's state and the cuBLAS
    workspace) and the params, Adam's state and the generator are then put
    back as they were, so the graph's first step is the one an eager step
    would take. The generator is registered with the graph: each replay
    draws fresh noise from it and moves it on as that many eager steps
    would. A failed capture or replay raises; nothing falls back to eager
    steps.

    On the CPU, and on a mesh (its collectives are not captured), a call
    runs the same steps eagerly, drawing from the generator in the same
    order.

    `noise` holds each step's (item_eps, theta_eps) of the last call; on
    the card they are the graph's static buffers, which each replay
    overwrites."""

    def __init__(self, trainer: "Trainer", item_scale: float,
                 num_samples: int, length: int, decoded: bool = False,
                 rows: int | None = None):
        self.trainer, self.item_scale = trainer, item_scale
        self.num_samples, self.length = num_samples, length
        self.decoded, self.rows = decoded, rows
        self.graph = None
        self.noise: list = []
        self._inputs: tuple = ()
        self._aux = None

    def _step(self, params, optimizer, x, y, generator):
        """One step on (packed, row_valid) or (response, mask); returns
        its noise and its aux row (4,)."""
        tr = self.trainer
        rows = _rows_arg(self.rows)
        if self.decoded:
            noise = tr.decoded_noise(x, self.num_samples, generator, *rows)
            aux = tr.minibatch_step_with_noise(params, optimizer, x, y,
                                               *noise, self.item_scale)
        else:
            noise = tr.packed_noise(x, self.num_samples, generator, *rows)
            aux = tr.step_with_noise(params, optimizer, x, y, *noise,
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
        params, optimizer, x, _, generator = args
        dev = x.device
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

    def __call__(self, params: dict, optimizer, x, y,
                 generator: torch.Generator) -> torch.Tensor:
        args = (params, optimizer, x, y, generator)
        if not x.is_cuda or self.trainer.mesh is not None:
            return self._steps(*args)
        inputs = (*tree_leaves(params), optimizer, x, y, generator)
        if self.graph is None:
            self._inputs = inputs
            self._capture(args)
        elif (len(inputs) != len(self._inputs)
              or any(a is not b for a, b in zip(inputs, self._inputs))):
            raise ValueError("a captured FusedSteps replays on the params, "
                             "optimizer, data and generator it was "
                             "captured with")
        self.graph.replay()
        return self._aux.clone()


def _rows_arg(rows: int | None) -> tuple:
    """The optional global row count as trailing arguments of packed_noise
    and decoded_noise: none when it is the data's own (off a mesh)."""
    return () if rows is None else (rows,)


def _rows_padded(x: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """x[lo:hi] with zero rows appended up to hi - lo rows (a mesh's padding
    rows past the data's end)."""
    out = x[lo:hi]
    if out.shape[0] < hi - lo:
        out = np.concatenate([out, np.zeros((hi - lo - out.shape[0],)
                                            + x.shape[1:], x.dtype)])
    return out


class Trainer:
    def __init__(self, model: VIBO, cfg: TrainConfig, device=None,
                 mesh: meshlib.Mesh | None = None):
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if not same_device(model.device, self.device):
            raise ValueError(f"model lives on {model.device}, trainer on "
                             f"{self.device}")
        if mesh is not None and not same_device(mesh.device, self.device):
            raise ValueError(f"the mesh's rank computes on {mesh.device}, "
                             f"the trainer on {self.device}")
        if cfg.objective not in ("elbo", "iwae"):
            raise ValueError(f"objective must be elbo|iwae, got "
                             f"{cfg.objective!r}")
        if cfg.restarts < 1:
            raise ValueError(f"restarts must be >= 1, got {cfg.restarts}")
        self.model = model
        self.cfg = cfg
        self.mesh = mesh

    def _update(self, params: dict, optimizer, loss, aux: dict,
                group=None) -> dict:
        """Descend `loss`: backward, the gradients summed over `group` (a
        mesh's; None: one device), clip, Adam; params update in place.
        Returns aux detached (0-d tensors, no host sync)."""
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        leaves = tree_leaves(params)
        if group is not None:
            meshlib.all_reduce_grads(leaves, group)
        if self.cfg.max_grad_norm is not None:
            with torch.no_grad():
                clip_by_global_norm_([p.grad for p in leaves],
                                     self.cfg.max_grad_norm)
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    # ------------------------------------------------------------- noise

    def _theta_transposed(self) -> bool:
        """The packed step's theta layout: (K, B) where the model wants it
        (wants_transposed_theta), except on a 2D tile, whose theta is (B,
        K) as in JAX."""
        if self.mesh is not None and self.mesh.num_items > 1:
            return False
        return self.model.wants_transposed_theta()

    def _rank_noise(self, noise: tuple, rows: int, transposed: bool):
        """On a mesh, the rank's rows of the whole noise: theta eps of
        `rows` rows zero-padded to the students axis, then sliced at
        mesh.student_rows; item eps whole (a 2D tile slices its block)."""
        if self.mesh is None:
            return noise
        item_eps, theta_eps = noise
        axis = 2 if transposed else 1
        pad = meshlib.pad_rows(rows, self.mesh.num_students) - rows
        if pad:
            widths = [0, 0] * (theta_eps.ndim - 1 - axis) + [0, pad]
            theta_eps = F.pad(theta_eps, widths)
        lo, hi = self.mesh.student_rows(rows)
        return item_eps, theta_eps.narrow(axis, lo, hi - lo)

    def packed_noise(self, packed, num_samples: int,
                     generator: torch.Generator, rows: int | None = None):
        """sample_noise for the packed step, theta eps in the layout the
        link's step runs (wants_transposed_theta). On a mesh the whole
        noise of `rows` global rows (default: packed's rows times the
        students axis) is drawn on every rank, which keeps its rows."""
        tp = self._theta_transposed()
        if rows is None:
            rows = packed.shape[0] * (1 if self.mesh is None
                                      else self.mesh.num_students)
        noise = self.model.sample_noise(rows, num_samples, transposed=tp,
                                        generator=generator)
        return self._rank_noise(noise, rows, tp)

    def decoded_noise(self, response, num_samples: int,
                      generator: torch.Generator, rows: int | None = None):
        """sample_noise for a step on decoded rows (a minibatch or the
        decoded full batch), theta eps (S, B, K); on a mesh the whole
        noise of `rows` global rows, the rank's rows kept (packed_noise)."""
        if rows is None:
            rows = response.shape[-2] * (1 if self.mesh is None
                                         else self.mesh.num_students)
        noise = self.model.sample_noise(rows, num_samples,
                                        generator=generator)
        return self._rank_noise(noise, rows, False)

    # ------------------------------------------------------------- steps

    def _axes(self) -> tuple:
        """(students group, items group, world group, students axis, items
        axis): the mesh's, or no groups and axes of 1 off a mesh, where
        every collective is the identity and each share the whole."""
        m = self.mesh
        if m is None:
            return None, None, None, 1, 1
        return m.students, m.items, m.world, m.num_students, m.num_items

    def step_with_noise(self, params: dict, optimizer, packed, row_valid,
                        item_eps: dict, theta_eps, item_scale: float = 1.0,
                        transposed: bool | None = None):
        """One packed full-batch step of cfg.objective on given noise: the
        ELBO, or the IWAE bound of the noise's S samples, item terms
        scaled by item_scale. transposed: the theta eps' layout (None: the
        step's own, packed_noise's).

        Off a mesh the JAX `_packed_raw_step`; on one, packed and row_valid
        are the rank's tile and theta_eps its rows, and the step is JAX's
        `_dp_raw_step` (students only) or `_dp2d_raw_step` (a 2D tile). The
        rank's loss is its share: ELBO -(ll - klt - item_scale kli / n_s)
        (klt / n_i on a 2D tile, where theta's terms repeat on every item
        shard), IWAE -bound / world (the psum'd log-weights, so the bound,
        are the same on every rank). The gradients are then summed over
        the whole mesh; ll, klt and kli are reported with JAX's psums. Off
        a mesh every axis is 1 and every group None, so the same lines are
        the one-device step."""
        tp = self._theta_transposed() if transposed is None else transposed
        model = self.model
        students, items, world, n_s, n_i = self._axes()
        if n_i == 1:
            if self.cfg.objective == "iwae":
                local, ratio = model.iwae_packed_terms(
                    params, packed, item_eps, theta_eps, row_valid,
                    transposed=tp, group=students)
                bound = objectives.iwae_bound(meshlib.psum(
                    local + item_scale * ratio / n_s, students))
                return self._update(params, optimizer, -bound / n_s,
                                    _iwae_aux(bound), world)
            ll, klt, kli = model.elbo_packed_sums(
                params, packed, item_eps, theta_eps, row_valid,
                transposed=tp, group=students)
            loss = -(ll - klt - item_scale * kli / n_s)
            ll_g, klt_g = meshlib.all_reduce_sum([ll, klt], students)
            kli_g = kli.detach()
        else:
            mesh = self.mesh
            if self.cfg.objective == "iwae":
                local = model.iwae_packed_terms_2d(
                    params, packed, item_eps, theta_eps, row_valid,
                    mesh.item_index, item_scale, items, students)
                bound = objectives.iwae_bound(meshlib.psum(local, world))
                return self._update(params, optimizer, -bound / (n_s * n_i),
                                    _iwae_aux(bound), world)
            ll, klt, kli = model.elbo_packed_sums_2d(
                params, packed, item_eps, theta_eps, row_valid,
                mesh.item_index, items, students)
            loss = -(ll - klt / n_i - item_scale * kli / n_s)
            (ll_g,) = meshlib.all_reduce_sum([ll], world)
            (klt_g,) = meshlib.all_reduce_sum([klt], students)
            (kli_g,) = meshlib.all_reduce_sum([kli], items)
        bound = objectives.elbo(ll_g, klt_g, kli_g, item_scale)
        return self._update(params, optimizer, loss,
                            {"elbo": bound, "loglik": ll_g,
                             "kl_theta": klt_g, "kl_items": kli_g}, world)

    def step(self, params: dict, optimizer, packed, row_valid,
             generator: torch.Generator, rows: int | None = None):
        """One packed full-batch step with cfg.num_mc_samples draws of
        noise from `generator` (packed_noise; rows: the global row count
        on a mesh)."""
        return self.step_with_noise(
            params, optimizer, packed, row_valid,
            *self.packed_noise(packed, self.cfg.num_mc_samples, generator,
                               *_rows_arg(rows)))

    def make_scan(self, item_scale: float, num_samples: int, length: int,
                  decoded: bool = False,
                  rows: int | None = None) -> FusedSteps:
        """`length` full-batch steps as one call (JAX `make_scan`;
        FusedSteps: a CUDA graph on the card), on the int8 code or, with
        `decoded`, on (response, mask)."""
        return FusedSteps(self, item_scale, num_samples, length, decoded,
                          rows)

    def minibatch_step_with_noise(self, params: dict, optimizer, response,
                                  mask, item_eps: dict, theta_eps,
                                  item_scale: float):
        """One step on decoded (response, mask) rows and given noise (the
        counterpart of the JAX `make_step`): cfg.objective with the item
        terms scaled by item_scale. On a mesh, the rows are the rank's
        share of the batch and theta_eps its rows' (the item axis
        replicates): its loss is its share, the gradients are summed over
        the students group (off a mesh the group is None and the share the
        whole, as in step_with_noise)."""
        model = self.model
        group, _, _, n_s, _ = self._axes()
        post = model.item_dist(params, response, mask, group=group)
        if self.cfg.objective == "iwae":
            local, ratio = model.iwae_terms(params, response, mask,
                                            item_eps, theta_eps, post=post)
            bound = objectives.iwae_bound(meshlib.psum(
                local + item_scale * ratio / n_s, group))
            return self._update(params, optimizer, -bound / n_s,
                                _iwae_aux(bound), group)
        ll, klt, kli = model.elbo_sums(params, response, mask, item_eps,
                                       theta_eps, post=post)
        ll_g, klt_g = meshlib.all_reduce_sum([ll, klt], group)
        bound = objectives.elbo(ll_g, klt_g, kli.detach(), item_scale)
        return self._update(
            params, optimizer, -(ll - klt - item_scale * kli / n_s),
            {"elbo": bound, "loglik": ll_g, "kl_theta": klt_g,
             "kl_items": kli.detach()}, group)

    def minibatch_step(self, params: dict, optimizer, response, mask,
                       item_scale: float, generator: torch.Generator,
                       rows: int | None = None):
        """minibatch_step_with_noise with cfg.num_mc_samples draws of noise
        from `generator` (decoded_noise; rows: the batch's global row count
        on a mesh)."""
        return self.minibatch_step_with_noise(
            params, optimizer, response, mask,
            *self.decoded_noise(response, self.cfg.num_mc_samples,
                                generator, *_rows_arg(rows)), item_scale)

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
        """Train on ds.train_mask: full batch on the int8 code (or on the
        decoded data with TrainConfig.packed=False), or person minibatches
        of cfg.batch_size decoded rows (batch_iterator, the last one
        zero-padded), in chunks of eval_every epochs, each ended by one
        host fetch of its per-epoch aux, the check_finite check and the
        held-out imputation accuracy. A full-batch chunk is one make_scan
        call under fuse_epochs (a new FusedSteps each fit, on this fit's
        objects), else one step an epoch.

        On a mesh the path is JAX's choice (packed: students-only or 2D
        steps; the decoded full batch and minibatches: the students' rows):
        the students are padded to a multiple of the students axis with
        zero rows whose row weight is 0, each rank copies only its own rows
        (its tile on a 2D mesh) to its device, the held-out evals run
        sharded (evaluation.imputation_accuracy_sharded), and only rank 0
        writes out_dir's files and echoes the records.

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

    def _is_writer(self) -> bool:
        """Whether this process writes files and echoes records: always off
        a mesh, rank 0 on one."""
        return self.mesh is None or self.mesh.rank == 0

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
            runs.append(Trainer(self.model, sub_cfg, device=self.device,
                                mesh=self.mesh)._fit_single(ds, truth, None))
        scores = np.asarray([run["final_elbo"] for run in runs], np.float64)
        selected = 0 if np.all(np.isnan(scores)) else int(np.nanargmax(scores))
        res = runs[selected]
        res["selected_restart"] = selected
        res["restarts"] = [
            {"restart": r, "seed": base.seed + r,
             "final_elbo": run["final_elbo"],
             "best_heldout_acc": run["best"]["heldout_acc"]}
            for r, run in enumerate(runs)]
        if base.out_dir and self._is_writer():
            src = os.path.join(base.out_dir, f"restart{selected}", "best.npz")
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(base.out_dir, "best.npz"))
        return res

    def _use_packed(self, full_batch: bool, m: int) -> bool:
        """TrainConfig.packed resolved by JAX's rules (`trainer.py`
        `_fit_single`): auto means every full batch unless an item-sharded
        mesh's items do not divide (then the decoded full batch); packed
        needs a full batch, and on an item-sharded mesh divisible items."""
        n_i = 1 if self.mesh is None else self.mesh.num_items
        items_mesh = n_i != 1
        can_2d = items_mesh and m % n_i == 0
        use_packed = self.cfg.packed
        if use_packed is None:
            return full_batch and (not items_mesh or can_2d)
        if use_packed and not full_batch:
            raise ValueError(
                "packed=True requires full-batch training (batch_size=None); "
                "the minibatch path trains on unpacked resp/mask")
        if use_packed and items_mesh and not can_2d:
            raise ValueError(
                "packed=True on an item-sharded mesh needs num_items "
                f"divisible by the items axis (got {m} items on "
                f"{n_i} item shards) — pad the dataset via "
                "data.masking.pad_to_multiple or use a students-only mesh")
        return use_packed

    def _rank_rows(self, x: np.ndarray) -> np.ndarray:
        """A host (N, ...) array's rows for this rank: all of them off a
        mesh; on one, its student rows of the rows padded to the students
        axis (zero rows past the end)."""
        if self.mesh is None:
            return x
        return _rows_padded(x, *self.mesh.student_rows(x.shape[0]))

    def _full_batch_data(self, ds: Dataset, use_packed: bool) -> tuple:
        """The full batch on this rank's device: (int8 code, row validity)
        or (response, mask) f32; on a mesh the rank's rows (and, for the
        code on a 2D mesh, its item block), the row validity the rows'
        global one (any observed training cell; 0 on padding rows)."""
        dev = self.device
        if not use_packed:
            return tuple(torch.from_numpy(np.ascontiguousarray(
                self._rank_rows(x), np.float32)).to(dev)
                for x in (ds.response, ds.train_mask))
        if self.mesh is None:
            return packed_on_device(ds.response, ds.train_mask, dev)
        resp, mask = self._rank_rows(ds.response), self._rank_rows(
            ds.train_mask)
        row_valid = (mask.sum(-1) > 0).astype(np.float32)
        if self.mesh.num_items > 1:
            c0, c1 = self.mesh.item_block(ds.response.shape[1])
            resp, mask = resp[:, c0:c1], mask[:, c0:c1]
        packed = pack_responses(np.ascontiguousarray(resp),
                                np.ascontiguousarray(mask))
        return (torch.from_numpy(packed).to(dev),
                torch.from_numpy(row_valid).to(dev))

    def _fit_single(self, ds: Dataset, truth, resume) -> dict:
        cfg = self.cfg
        n, m = ds.response.shape
        batch_size = min(cfg.batch_size or n, n)
        item_scale = batch_size / n
        full_batch = batch_size >= n
        use_packed = self._use_packed(full_batch, m)
        steps_per_epoch = 1 if full_batch else -(-n // batch_size)
        dev = self.device
        mesh = self.mesh
        rows = None if mesh is None else n    # the noise's global rows
        writer = self._is_writer()
        if cfg.warm_start and resume:
            raise ValueError("warm_start and resume are mutually exclusive: "
                             "resume restores exact state; warm_start "
                             "transplants params into a fresh run")
        if full_batch:
            data = self._full_batch_data(ds, use_packed)
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
        if mesh is not None:
            # replicated params: every rank starts from rank 0's
            meshlib.broadcast_params(tree_leaves(params), mesh)
        if cfg.out_dir and writer:
            os.makedirs(cfg.out_dir, exist_ok=True)
        logger = MetricsLogger(os.path.join(cfg.out_dir, "metrics.jsonl")
                               if cfg.out_dir and writer else None,
                               echo=writer)

        def run_epoch(epoch: int):
            """One epoch's steps -> its aux row (the ELBO's mean over the
            steps, the last step's other terms)."""
            if full_batch:
                aux = (self.step(params, optimizer, *data, gen, rows)
                       if use_packed else
                       self.minibatch_step(params, optimizer, *data, 1.0,
                                           gen, rows))
                elbos = [aux["elbo"]]
            else:
                elbos = []
                for resp, mask in batch_iterator(ds, batch_size, cfg.seed,
                                                 epoch):
                    aux = self.minibatch_step(
                        params, optimizer,
                        torch.from_numpy(self._rank_rows(resp)).to(dev),
                        torch.from_numpy(self._rank_rows(mask)).to(dev),
                        item_scale, gen,
                        None if mesh is None else resp.shape[0])
                    elbos.append(aux["elbo"])
            return torch.stack([torch.stack(elbos).mean(),
                                *(aux[k] for k in AUX_KEYS[1:])])

        scans = {}

        def run_chunk(first: int, length: int):
            if not (full_batch and cfg.fuse_epochs):
                return torch.stack([run_epoch(e)
                                    for e in range(first, first + length)])
            if length not in scans:
                scans[length] = self.make_scan(
                    item_scale, cfg.num_mc_samples, length,
                    decoded=not use_packed, rows=rows)
            return scans[length](params, optimizer, *data, gen)

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
                ev = (evaluation.imputation_accuracy(self.model, params, ds)
                      if mesh is None else
                      evaluation.imputation_accuracy_sharded(
                          self.model, params, ds, mesh))
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
                    if cfg.out_dir and writer:
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


def _iwae_aux(bound) -> dict:
    """The IWAE step's aux: the bound as 'elbo' and 'loglik', zeroed KL
    fields (as in JAX)."""
    zero = torch.zeros((), device=bound.device)
    return {"elbo": bound, "loglik": bound, "kl_theta": zero,
            "kl_items": zero}
