"""The CLI references of chip_smoke.py's CLI phases: the JAX package's own
command line, run on the CPU, for the commands the smoke runs on the card.

    python tests/cli_reference.py [--seeds N] [--out FILE] [cfg1] [grm]
        [deep] [k2nuts] [items]

runs each named command (chip_smoke.py's CLI_CFG1, CLI_GRM, CLI_DEEP,
CLI_K2NUTS and CLI_ITEMS, with --cpu) and prints one JSON line a command:
its summary (grm, k2nuts: the table). With --seeds N, cfg1, grm, k2nuts
and items are run again with the training seed set to 0 .. N-1 and the
data left at the command's --seed (the spread of the JAX package's own
runs; grm and k2nuts with --methods hmc, the VIBO row against the cached
gold): cfg1 keeps the held-out accuracy and the theta and b Pearsons of
each seed, grm and k2nuts the VIBO row's held-out accuracy and its
agreement with the gold (k2nuts also b_vs_hmc and a_vs_hmc, which the JAX
CLI leaves out of a row compared with a cached gold: computed here from
the VIBO leg's summary against the gold's item means, as the port's CLI
computes them), items the held-out and the new items' accuracy.
--out also writes the lines to FILE (appending with --append). Not a test
module: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
SEED_KEYS = {"cfg1": ("heldout_acc", "theta_pearson", "b_pearson"),
             "grm": ("heldout_acc", "theta_vs_hmc", "sigma_vs_hmc",
                     "laplace_sigma_vs_hmc"),
             "k2nuts": ("heldout_acc", "theta_vs_hmc", "sigma_vs_hmc",
                        "laplace_sigma_vs_hmc", "b_vs_hmc", "a_vs_hmc"),
             "items": ("heldout_acc", "new_item_acc", "new_item_base_rate")}
# the commands whose seed runs keep only the VIBO row and the cached gold
COMPARE = ("grm", "k2nuts")


def run(cli, argv: list, train_seed: int | None = None):
    """cli.main(argv + --cpu); with train_seed, every TrainConfig the
    command builds takes that seed instead of --seed."""
    import vibo_tpu.train as train
    if train_seed is None:
        return cli.main(argv + ["--cpu"])
    base = train.TrainConfig
    with mock.patch.object(train, "TrainConfig",
                           lambda **kw: base(**{**kw, "seed": train_seed})):
        return cli.main(argv + ["--cpu"])


def item_agreement(cli, argv: list, train_seed: int) -> tuple:
    """(VIBO row, b_vs_hmc, a_vs_hmc) of a compare run against its
    --hmc-cache gold: the VIBO leg's item means against the gold's (b
    directly, a through the Procrustes rotation of the theta means)."""
    import numpy as np

    from vibo_tpu import evaluation
    legs = []
    orig = cli.cmd_train

    def train(args):
        legs.append(orig(args))
        return legs[-1]
    with mock.patch.object(cli, "cmd_train", train):
        row = run(cli, argv, train_seed=train_seed)[0]
    leg = legs[-1]
    cache = argv[argv.index("--hmc-cache") + 1]
    with np.load(f"{cache}/baseline_hmc.npz") as z:
        b_ref, a_ref, t_ref = z["b_hat"], z["a_hat"], z["theta_hat"]
    w = evaluation.procrustes_rotation(leg["_theta_hat"], t_ref)
    b = evaluation.correlation(np.asarray(leg["_b_hat"]).ravel(),
                               b_ref.ravel())["pearson"]
    a = evaluation.correlation((np.asarray(leg["_a_hat"]) @ w).ravel(),
                               a_ref.ravel())["pearson"]
    return row, round(b, 4), round(a, 4)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("commands", nargs="*", default=["cfg1", "grm"],
                   choices=["cfg1", "grm", "deep", "k2nuts", "items"])
    p.add_argument("--seeds", type=int, default=0)
    p.add_argument("--out", type=Path)
    p.add_argument("--append", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from vibo_tpu import cli
    commands = {"cfg1": list(chip_smoke.CLI_CFG1),
                "grm": list(chip_smoke.CLI_GRM),
                "deep": list(chip_smoke.CLI_DEEP),
                "k2nuts": list(chip_smoke.CLI_K2NUTS),
                "items": list(chip_smoke.CLI_ITEMS)}
    lines = []
    for name in args.commands:
        out = run(cli, commands[name])
        command = " ".join(a.replace(f"{ROOT}/", "") for a in commands[name])
        line = {"reference": name, "command": command,
                "result": cli._public(out) if isinstance(out, dict) else out}
        if name in SEED_KEYS and args.seeds:
            argv = commands[name] + (["--methods", "hmc"]
                                     if name in COMPARE else [])
            by_seed = {}
            for s in range(args.seeds):
                if name == "k2nuts":
                    row, b_agree, a_agree = item_agreement(cli, argv, s)
                    row = {**row, "b_vs_hmc": b_agree, "a_vs_hmc": a_agree}
                else:
                    res = run(cli, argv, train_seed=s)
                    row = res if isinstance(res, dict) else res[0]
                by_seed[s] = {k: row.get(k) for k in SEED_KEYS[name]}
            line["by_training_seed"] = by_seed
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        text = "".join(json.dumps(x) + "\n" for x in lines)
        with open(args.out, "a" if args.append else "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
