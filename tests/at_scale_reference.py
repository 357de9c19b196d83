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
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from vibo_tpu import evaluation as jeval  # noqa: E402
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig  # noqa: E402
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack  # noqa: E402
from vibo_tpu.train import Trainer as JTrainer  # noqa: E402
from vibo_tpu.train import TrainConfig as JTrainConfig  # noqa: E402
from vibo_tpu_torch import evaluation  # noqa: E402
from vibo_tpu_torch.convert import params_from_jax  # noqa: E402
from vibo_tpu_torch.models import VIBO, VIBOConfig  # noqa: E402
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(one_seed(seed, args.compute_dtype)), flush=True)


if __name__ == "__main__":
    main()
