"""The at-scale fit, the JAX package's against the port's, on the CPU at one
size and several seeds. For each seed: one CSV (the port's generator,
byte-equal to the reference's), ingested and split once; JAX trained as
scripts/run_at_scale.py trains (init_state(key(seed)), make_scan chunks
from key(seed + 1)) and the port as vibo_tpu_torch.scripts.run_at_scale
trains (params from seed, noise from a generator seeded seed + 1). Then
the held-out IWAE a cell of each fit by its own evaluator (JAX: key 7; the
port: a generator seeded 7), the port's evaluator on JAX's params, and on
the two fits with their encoders swapped (each fit's encoder with the
other's item posterior), and both held-out accuracies.

    python tests/at_scale_reference.py [--seeds 0 1 2]
        [--compute-dtype bfloat16|float32]

at SIZE: the CSV of 400,000 rows over 4,000 users and 256 lexemes, the
at-scale widths (hidden 256, S = 5), 1,500 epochs and IWAE-100; the size
of `run_at_scale --cpu --rows 400000 --users 4000 --lexemes 256` and of
JAX's `scripts/run_at_scale.py` with the same flags.

prints one JSON line a seed; the CSV goes where run_at_scale puts it
(under build/, written if absent). Not a test module: pytest does not
collect it.

    python tests/at_scale_reference.py --paired [--seeds 0 1 2 3 4]
        [--compute-dtype bfloat16|float32] [--epochs 1500]

pairs the two fits instead (`paired_seed`): the port starts from JAX's
initial params (`params_from_jax` of init_state(key(seed)), a fresh Adam,
which is optax's initial state) and takes, step by step through
`Trainer.step_with_noise`, the noise JAX's make_scan draws (its key chain:
one split a chunk of 100 epochs, one a step; `sample_noise(...,
transposed=True)`). Every 25 steps of JAX's run, the port's gradient on
JAX's state and noise is held against JAX's and, at bf16, both against
the f32 gradient of the same state and noise (`grad_gaps`). One JSON line
a seed (both IWAE-100s by the port's evaluator on one noise, both
held-out accuracies, both ELBOs at the end of every chunk, the gradient
gaps averaged over the trajectory a leaf), then a summary line: the
paired differences port - JAX (mean, standard error, signs). A seed takes
7-13 minutes on 4 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from vibo_tpu import evaluation as jeval  # noqa: E402
from vibo_tpu.ops import objectives as jobjectives  # noqa: E402
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig  # noqa: E402
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack  # noqa: E402
from vibo_tpu.train import Trainer as JTrainer  # noqa: E402
from vibo_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from vibo_tpu_torch import evaluation  # noqa: E402
from vibo_tpu_torch.convert import params_from_jax, tree_leaves  # noqa: E402
from vibo_tpu_torch.models import VIBO, VIBOConfig  # noqa: E402
from vibo_tpu_torch.ops import objectives  # noqa: E402
from vibo_tpu_torch.ops.packing import pack_responses  # noqa: E402
from vibo_tpu_torch.scripts import run_at_scale  # noqa: E402
from vibo_tpu_torch.train import Trainer, TrainConfig  # noqa: E402
from vibo_tpu_torch.train import make_optimizer  # noqa: E402

SIZE = dict(rows=400_000, users=4_000, lexemes=256, hidden_dim=256,
            num_samples=5, epochs=1500, iwae_samples=100)


def fit_jax(train_ds, cfg: dict, seed: int, epochs: int, s: int):
    """scripts/run_at_scale.py's training -> (model, params)."""
    model = JVIBO(JConfig(**cfg))
    trainer = JTrainer(model, JTrainConfig(lr=5e-3))
    p, o = trainer.init_state(jax.random.key(seed))
    code = jnp.asarray(jpack(train_ds.response, train_ds.train_mask))
    rv = jnp.asarray((train_ds.train_mask.sum(-1) > 0).astype(np.float32))
    scan = trainer.make_scan(1.0, s, 100, packed=True, donate=False)
    key = jax.random.key(seed + 1)
    for _ in range(max(1, epochs // 100)):
        key, sub = jax.random.split(key)
        p, o, _, _ = scan(p, o, sub, code, rv)
    return model, p


def fit_port(train_ds, cfg: dict, seed: int, epochs: int, s: int):
    """run_at_scale.run's training (its timed run) -> (model, params)."""
    model = VIBO(VIBOConfig(**cfg), device="cpu")
    trainer = Trainer(model, TrainConfig(lr=5e-3), device="cpu")
    params = model.init_params(seed)
    opt = make_optimizer(params, trainer.cfg.lr)
    code = torch.from_numpy(pack_responses(train_ds.response,
                                           train_ds.train_mask))
    rv = torch.from_numpy(
        (train_ds.train_mask.sum(-1) > 0).astype(np.float32))
    scan = trainer.make_scan(1.0, s, 100)
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    for _ in range(max(1, epochs // 100)):
        scan(params, opt, code, rv, gen)
    return model, params


def port_iwae(model, params, train_ds, samples: int) -> float:
    gen = torch.Generator()
    gen.manual_seed(7)
    return evaluation.iwae_loglik(model, params, train_ds,
                                  num_samples=samples,
                                  generator=gen)["loglik_per_cell"]


def one_seed(seed: int, compute_dtype: str) -> dict:
    rows, users, lexemes = SIZE["rows"], SIZE["users"], SIZE["lexemes"]
    csv = run_at_scale.default_csv(rows, users, lexemes, seed)
    train_ds, _, _ = run_at_scale.ingest(csv, rows, users, lexemes, seed,
                                         0.03)
    cfg = dict(num_items=train_ds.response.shape[1], irt_model="2pl",
               ability_dim=1, hidden_dim=SIZE["hidden_dim"],
               use_pallas=True, compute_dtype=compute_dtype)
    s, epochs, n = SIZE["num_samples"], SIZE["epochs"], SIZE["iwae_samples"]
    jmodel, jp = fit_jax(train_ds, cfg, seed, epochs, s)
    model, params = fit_port(train_ds, cfg, seed, epochs, s)
    jparams = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return {
        "seed": seed, "compute_dtype": compute_dtype, "epochs": epochs,
        "jax_iwae": float(jeval.iwae_loglik(
            jmodel, jp, jax.random.key(7), train_ds,
            num_samples=n)["loglik_per_cell"]),
        "port_iwae": port_iwae(model, params, train_ds, n),
        "jax_params_port_evaluator": port_iwae(model, jparams, train_ds, n),
        "jax_encoder_port_items": port_iwae(
            model, {**jparams, "item_post": params["item_post"]}, train_ds,
            n),
        "port_encoder_jax_items": port_iwae(
            model, {**params, "item_post": jparams["item_post"]}, train_ds,
            n),
        "jax_heldout_acc": evaluation.imputation_accuracy(
            model, jparams, train_ds)["acc"],
        "port_heldout_acc": evaluation.imputation_accuracy(
            model, params, train_ds)["acc"]}


# -- paired mode ---------------------------------------------------------------

def _named(tree, path: str = "") -> dict:
    """{path: float64 array} of a params or gradient tree (numpy or torch
    leaves), paths as "encoder/0/w", "item_post/a/mu"."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_named(tree[k], f"{path}/{k}" if path else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_named(v, f"{path}/{i}" if path else str(i)))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {path: np.asarray(tree, np.float64)}


def _jax_grad_fn(jmodel):
    """jit(value_and_grad) of JAX's packed step loss, -ELBO at item_scale
    1 (Trainer._packed_raw_step), on given params, noise and code."""
    def loss(p, item_eps, theta_eps, code, rv):
        ll, klt, kli = jmodel.elbo_packed_sums(p, code, item_eps, theta_eps,
                                               rv, transposed=True)
        return -jobjectives.elbo(ll, klt, kli, 1.0)
    return jax.jit(jax.value_and_grad(loss))


def _port_grad(model, p_np, item_eps, theta_eps, code, rv) -> tuple:
    """(-ELBO, {path: gradient}) of the port's packed step loss on JAX's
    params `p_np` and the given noise (Trainer.step_with_noise's loss)."""
    params = params_from_jax(p_np, "cpu")
    ll, klt, kli = model.elbo_packed_sums(params, code, item_eps, theta_eps,
                                          rv, transposed=True)
    loss = -objectives.elbo(ll, klt, kli, 1.0)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    # _named walks the tree in tree_leaves' order
    return float(loss.detach()), {k: g.numpy().astype(np.float64)
                         for k, g in zip(_named(params), grads)}


def grad_gaps(gj: dict, gp: dict, gf: dict) -> dict:
    """Per leaf, the port's gradient gp against JAX's gj and both against
    the f32 gradient gf of the same state and noise: rel_l2 |gp - gj| /
    |gj|; proj (gp - gj).gj / |gj|^2 (the port's error along JAX's
    gradient); jax_to_f32, port_to_f32 |g - gf| / |gf|; jax_proj_f32,
    port_proj_f32 (g - gf).gf / |gf|^2."""
    out = {}
    for name in gj:
        j, p, f = gj[name].ravel(), gp[name].ravel(), gf[name].ravel()
        nj, nf = max(j @ j, 1e-300), max(f @ f, 1e-300)
        out[name] = {
            "rel_l2": float(np.linalg.norm(p - j) / np.sqrt(nj)),
            "proj": float((p - j) @ j / nj),
            "jax_to_f32": float(np.linalg.norm(j - f) / np.sqrt(nf)),
            "port_to_f32": float(np.linalg.norm(p - f) / np.sqrt(nf)),
            "jax_proj_f32": float((j - f) @ f / nf),
            "port_proj_f32": float((p - f) @ f / nf)}
    return out


def summarize_gaps(points: list) -> dict:
    """grad_gaps over the trajectory -> per leaf the mean of each
    measure, the points whose proj is positive, and the points where the
    port's gradient lies farther from f32 than JAX's."""
    out = {}
    for name in points[0]:
        rows = [pt[name] for pt in points]
        leaf = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
        leaf["proj_positive"] = sum(r["proj"] > 0 for r in rows)
        leaf["port_farther"] = sum(r["port_to_f32"] > r["jax_to_f32"]
                                   for r in rows)
        out[name] = leaf
    return out


def paired_seed(seed: int, compute_dtype: str, size: dict = SIZE,
                chunk: int = 100, grad_every: int = 25,
                csv: str | None = None) -> dict:
    """One seed of the paired comparison (module doc). The JAX fit is
    scripts/run_at_scale.py's (init_state(key(seed)), make_scan chunks of
    `chunk` epochs from key(seed + 1)), run as scans of `grad_every` steps
    that carry the chunk's key on (the same key chain and steps); the
    port's fit starts from JAX's initial params and steps on the noise
    each of JAX's steps drew. At the start of every scan, the gradient
    gaps (grad_gaps) on JAX's state and that step's noise."""
    if chunk % grad_every:
        raise ValueError("chunk must be a multiple of grad_every")
    t_start = time.perf_counter()
    rows, users, lexemes = size["rows"], size["users"], size["lexemes"]
    csv = csv or run_at_scale.default_csv(rows, users, lexemes, seed)
    train_ds, _, _ = run_at_scale.ingest(csv, rows, users, lexemes, seed,
                                         0.03)
    cfg = dict(num_items=train_ds.response.shape[1], irt_model="2pl",
               ability_dim=1, hidden_dim=size["hidden_dim"],
               use_pallas=True, compute_dtype=compute_dtype)
    s, epochs = size["num_samples"], size["epochs"]
    n = train_ds.response.shape[0]

    jmodel = JVIBO(JConfig(**cfg))
    jtrainer = JTrainer(jmodel, JTrainConfig(lr=5e-3))
    jp, jo = jtrainer.init_state(jax.random.key(seed))
    jcode = jnp.asarray(jpack(train_ds.response, train_ds.train_mask))
    jrv = jnp.asarray((train_ds.train_mask.sum(-1) > 0).astype(np.float32))
    scan = jtrainer.make_scan(1.0, s, grad_every, packed=True, donate=False)
    jgrad = _jax_grad_fn(jmodel)
    jgrad32 = (jgrad if compute_dtype == "float32" else
               _jax_grad_fn(JVIBO(JConfig(**{**cfg,
                                             "compute_dtype": "float32"}))))

    @jax.jit
    def scan_noise(k):
        """The noise each step of a scan from carry key k draws."""
        def body(k, _):
            k, sub = jax.random.split(k)
            return k, jmodel.sample_noise(None, sub, n, s, transposed=True)
        return jax.lax.scan(body, k, None, length=grad_every)[1]

    model = VIBO(VIBOConfig(**cfg), device="cpu")
    model32 = (model if compute_dtype == "float32" else
               VIBO(VIBOConfig(**{**cfg, "compute_dtype": "float32"}),
                    device="cpu"))
    trainer = Trainer(model, TrainConfig(lr=5e-3), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    opt = make_optimizer(params, trainer.cfg.lr)
    code = torch.from_numpy(pack_responses(train_ds.response,
                                           train_ds.train_mask))
    rv = torch.from_numpy(np.array(jrv))

    def port_noise(noise, i):
        item, theta = noise
        return ({k: torch.from_numpy(np.array(v[i]))
                 for k, v in item.items()},
                torch.from_numpy(np.array(theta[i])))

    jelbo, pelbo, points, f32_check, replay = [], [], [], [], []
    key = jax.random.key(seed + 1)
    for _ in range(max(1, epochs // chunk)):
        key, k = jax.random.split(key)
        for _ in range(chunk // grad_every):
            noise = scan_noise(k)
            item0, theta0 = port_noise(noise, 0)
            first = (jax.tree.map(lambda x: x[0], noise[0]), noise[1][0])
            jloss, gj = jgrad(jp, *first, jcode, jrv)
            gj = _named(jax.tree.map(np.asarray, gj))
            gf = (gj if jgrad32 is jgrad else
                  _named(jax.tree.map(np.asarray,
                                      jgrad32(jp, *first, jcode, jrv)[1])))
            p_np = jax.tree.map(np.asarray, jp)
            _, gp = _port_grad(model, p_np, item0, theta0, code, rv)
            points.append(grad_gaps(gj, gp, gf))
            if model32 is not model:
                gp32 = _port_grad(model32, p_np, item0, theta0, code, rv)[1]
                f32_check.append(max(grad_gaps(gf, gp32, gf)[k]["rel_l2"]
                                     for k in gf))
            jp, jo, k, aux = scan(jp, jo, k, jcode, jrv)
            steps = np.asarray(aux["elbo"], np.float64)
            replay.append(abs(-float(jloss) - steps[0])
                          / max(abs(steps[0]), 1.0))
            jelbo.append(steps)
            for i in range(grad_every):
                a = trainer.step_with_noise(params, opt, code, rv,
                                            *port_noise(noise, i), 1.0,
                                            transposed=True)
                pelbo.append(float(a["elbo"]))
    jelbo = np.concatenate(jelbo)
    ends = np.arange(chunk - 1, len(pelbo), chunk)
    jparams = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    out = {
        "seed": seed, "compute_dtype": compute_dtype, "epochs": len(pelbo),
        "jax_iwae": port_iwae(model, jparams, train_ds, size["iwae_samples"]),
        "port_iwae": port_iwae(model, params, train_ds,
                               size["iwae_samples"]),
        "jax_iwae_jax_evaluator": float(jeval.iwae_loglik(
            jmodel, jp, jax.random.key(7), train_ds,
            num_samples=size["iwae_samples"])["loglik_per_cell"]),
        "jax_heldout_acc": evaluation.imputation_accuracy(
            model, jparams, train_ds)["acc"],
        "port_heldout_acc": evaluation.imputation_accuracy(
            model, params, train_ds)["acc"],
        "first_step_elbo": [float(jelbo[0]), pelbo[0]],
        "jax_chunk_elbo": [float(jelbo[i]) for i in ends],
        "port_chunk_elbo": [pelbo[i] for i in ends],
        "jax_noise_replay_max_rel": float(max(replay)),
        "grad_points": len(points),
        "grad_gaps": summarize_gaps(points)}
    if f32_check:
        out["port_f32_vs_jax_f32_grad_max_rel"] = float(max(f32_check))
    out["seconds"] = round(time.perf_counter() - t_start, 1)
    return out


def paired_summary(lines: list) -> dict:
    """Paired differences port - JAX over the seeds: mean, standard error
    and the count of each sign, for IWAE-100 and held-out accuracy."""
    out = {"summary": True, "compute_dtype": lines[0]["compute_dtype"],
           "seeds": [ln["seed"] for ln in lines]}
    for metric in ("iwae", "heldout_acc"):
        d = np.array([ln[f"port_{metric}"] - ln[f"jax_{metric}"]
                      for ln in lines])
        se = float(d.std(ddof=1) / np.sqrt(len(d))) if len(d) > 1 else None
        out[metric] = {"mean": float(d.mean()), "se": se,
                       "positive": int((d > 0).sum()),
                       "negative": int((d < 0).sum())}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--paired", action="store_true",
                    help="the paired comparison (module doc)")
    ap.add_argument("--epochs", type=int, default=SIZE["epochs"],
                    help="paired mode: epochs (a multiple of 100)")
    args = ap.parse_args()
    size = {**SIZE, "epochs": args.epochs}
    lines = []
    for seed in args.seeds:
        line = (paired_seed(seed, args.compute_dtype, size) if args.paired
                else one_seed(seed, args.compute_dtype))
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.paired:
        print(json.dumps(paired_summary(lines)), flush=True)


if __name__ == "__main__":
    main()
