"""The EM flagship reference: the JAX package's `fit_em` on the data of
`python -m vibo_tpu.cli baseline synthetic-2pl --num-persons 10240
--num-items 1024 --method em` (simulate_irt("2pl", 10,240, 1,024, K = 1,
seed 0, missing rate 0), 10 % held out with seed 0), run on the CPU.

    python tests/em_reference.py

writes artifacts/em/flagship_2pl_k1.npz: a, b, theta_eap, log_marginal and
iterations, with the held-out accuracy and the theta Pearson against the
simulated truth (the CLI's summary numbers). chip_smoke.py holds the port's
EM on the card against it with numpy only. Not a test module: pytest does
not collect it.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "artifacts" / "em" / "flagship_2pl_k1.npz"
SHAPE = (10240, 1024)


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from vibo_tpu import evaluation
    from vibo_tpu.data import holdout_split, simulate_irt
    from vibo_tpu.models import em

    sim = simulate_irt("2pl", *SHAPE, ability_dim=1, seed=0,
                       missing_rate=0.0)
    ds = holdout_split(sim.response, sim.mask, 0.1, seed=0)
    res = em.fit_em(ds.response, ds.train_mask, em.EMConfig())
    prob = em.response_prob(res)
    h = ds.heldout_mask
    acc = float((h * ((prob > 0.5) == ds.response)).sum() / h.sum())
    pearson = evaluation.correlation(res["theta_eap"],
                                     sim.theta[:, 0])["pearson"]
    summary = {"shape": list(SHAPE), "log_marginal": res["log_marginal"],
               "iterations": res["iterations"], "heldout_acc": acc,
               "theta_pearson": pearson, "jax": jax.__version__}
    os.makedirs(OUT.parent, exist_ok=True)
    np.savez(OUT, a=res["a"], b=res["b"], theta_eap=res["theta_eap"],
             log_marginal=np.float64(res["log_marginal"]),
             iterations=np.int64(res["iterations"]),
             summary_json=json.dumps(summary))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
