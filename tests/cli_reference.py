"""The CLI references of chip_smoke.py's CLI phases: the JAX package's own
command line, run on the CPU, for the commands the smoke runs on the card.

    python tests/cli_reference.py [--seeds N] [--out FILE] [cfg1] [grm] [deep]

runs each named command (chip_smoke.py's CLI_CFG1, CLI_GRM and CLI_DEEP,
with --cpu) and prints one JSON line a command: its summary (grm: the
table). With --seeds N, cfg1 and grm are run again with the training seed
set to 0 .. N-1 and the data left at the command's --seed (the spread of
the JAX package's own runs; grm with --methods hmc, the VIBO row against
the cached gold): cfg1 keeps the held-out accuracy and the theta and b
Pearsons of each seed, grm the VIBO row's held-out accuracy and its
agreement with the gold. --out also writes the lines to FILE. Not a test
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
                     "laplace_sigma_vs_hmc")}


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


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("commands", nargs="*", default=["cfg1", "grm"],
                   choices=["cfg1", "grm", "deep"])
    p.add_argument("--seeds", type=int, default=0)
    p.add_argument("--out", type=Path)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from vibo_tpu import cli
    commands = {"cfg1": list(chip_smoke.CLI_CFG1),
                "grm": list(chip_smoke.CLI_GRM),
                "deep": list(chip_smoke.CLI_DEEP)}
    lines = []
    for name in args.commands:
        out = run(cli, commands[name])
        command = " ".join(a.replace(f"{ROOT}/", "") for a in commands[name])
        line = {"reference": name, "command": command,
                "result": cli._public(out) if isinstance(out, dict) else out}
        if name in SEED_KEYS and args.seeds:
            argv = commands[name] + (["--methods", "hmc"]
                                     if name == "grm" else [])
            by_seed = {}
            for s in range(args.seeds):
                res = run(cli, argv, train_seed=s)
                row = res if isinstance(res, dict) else res[0]
                by_seed[s] = {k: row.get(k) for k in SEED_KEYS[name]}
            line["by_training_seed"] = by_seed
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
