"""Depth sweep of chip_smoke.py's HMC gold comparisons on one card.

    python3 hmc_depth.py [--smoke] [gold ...]

Runs the port's `run_hmc` on the data of artifacts/gold/k4 (2PL, 10,240 x
1,024, K = 4, the (B, K) one-pass kernel) and of artifacts/gold/grm (2,000 x
100, C = 5, the dense potential) at each (warm-up, draws, leapfrogs) of
DEPTHS, and on the data of the NUTS golds k2-nuts (2PL, 2,000 x 200, K = 2,
the one-pass kernel), grm-k2 and grm-k4 (2,000 x 200, K = 2 and 4, C = 5,
dense) at each (warm-up, draws), NUTS at the golds' tree depth 7 and target
0.8; with chip_smoke.py's chains and seed (the fixed runs at its accept
target). Prints one JSON line a run: its seconds, accept rate, R-hat,
leapfrogs a draw, and the agreement with the gold and whether its gates
hold (`chip_smoke.gold_agreement`). Then the card's name and power limit,
and last {"ok": true} when every run held its gates. Arguments: only those
golds; --smoke: each gold at chip_smoke.py's HMC_GOLD_DEPTH only.
chip_smoke.py's HMC_GOLD_DEPTH is taken from such a sweep. run_hmc replays
its iterations from CUDA graphs (`hmc.Sampler`), so the sweep reaches the
k4 gold's own 800 + 1,600 iterations (~1 min of the card).
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as cs

DEPTHS = {"k4": [(50, 50, 64), (100, 100, 64), (200, 200, 64),
                 (400, 400, 64), (800, 1600, 64)],
          "grm": [(30, 30, 32), (50, 50, 32), (100, 100, 32),
                  (200, 200, 32)],
          **{gold: [(30, 30), (50, 50), (100, 100), (200, 200)]
             for gold in cs.NUTS_GOLDS}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("hmc_depth.py needs a CUDA card")
    from vibo_tpu_torch._device import resolve_device
    from vibo_tpu_torch.models import hmc
    resolve_device(None)
    smi = cs.nvidia_smi("name,power.limit")
    args = sys.argv[1:]
    smoke = "--smoke" in args
    golds = [a for a in args if a != "--smoke"]
    ok = True
    for gold, depths in DEPTHS.items():
        if golds and gold not in golds:
            continue
        if smoke:
            depths = [cs.HMC_GOLD_DEPTH[gold]]
        ds = cs.gold_data(gold)
        model, k = {"k4": ("2pl", cs.K), "grm": ("grm", 1),
                    **cs.NUTS_GOLDS}[gold]
        c = cs.C if model == "grm" else 2
        for depth in depths:
            cfg = cs.hmc_cfg(model, k, c, depth=depth)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = hmc.run_hmc(ds.response, ds.train_mask, cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            prob = hmc.posterior_mean_prob(out["samples"], model)
            r = {"gold": gold, "depth": list(depth), "seconds": seconds,
                 "accept_rate": out["accept_rate"],
                 "step_size": out["step_size"],
                 "rhat_max": out["diagnostics"]["rhat_max"],
                 "leapfrogs_per_draw": out["diagnostics"][
                     "leapfrogs_per_draw"],
                 "divergences": out["diagnostics"]["divergences"],
                 **cs.gold_agreement(out["samples"],
                                     cs.heldout_accuracy(prob, ds), gold)}
            ok = ok and r["gold_gates_hold"]
            print(json.dumps(r), flush=True)
    print(smi)
    print(json.dumps({"ok": ok}))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
