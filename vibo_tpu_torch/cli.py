"""Command line of the port (counterpart of `vibo_tpu.cli`, the same
subcommands, flags, defaults and summary keys): train and evaluate VIBO, run
the MLE/MAP, EM and HMC baselines, compare them on one split, and score new
students (or new items) from a checkpoint.

  python -m vibo_tpu_torch.cli train synthetic-1pl --irt-model 1pl \\
      --num-persons 1000 --num-items 100 --epochs 200 --eval-every 100
  python -m vibo_tpu_torch.cli baseline pisa --method em
  python -m vibo_tpu_torch.cli compare synthetic-grm --irt-model grm \\
      --hmc-cache artifacts/gold/grm
  python -m vibo_tpu_torch.cli score --checkpoint run/best.npz \\
      --input new.npz --output scores.npz
  torchrun --nproc_per_node 4 -m vibo_tpu_torch.cli train synthetic-2pl \\
      --data-parallel         # students over 4 cards; rank 0 prints

Every command runs on the CUDA card and raises where there is none;
`--cpu` runs it on the CPU (the plain PyTorch versions of the kernels). On
the card `train` turns the kernels on (use_pallas) for 1PL, 2PL, 3PL, GRM
and GPCM, as the JAX CLI does on its TPU; the deep link stays on its plain
route. Each command prints its summary as one JSON line last.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

_FAMILIES = ("1pl", "2pl", "3pl", "grm", "gpcm")
_POLYTOMOUS = ("grm", "gpcm")


def _device(args):
    """The device every model, trainer, baseline and scorer of the command
    is built on: the CPU with --cpu, else the card (None)."""
    return "cpu" if getattr(args, "cpu", False) else None


def _add_common(p):
    p.add_argument("dataset",
                   help="synthetic-{1pl,2pl,3pl,nonlinear,grm,gpcm} | pisa "
                        "| duolingo | wordbank "
                        "| critlangacq | gradescope")
    p.add_argument("--num-persons", type=int, default=1000)
    p.add_argument("--num-items", type=int, default=100)
    p.add_argument("--ability-dim", type=int, default=1)
    p.add_argument("--num-categories", type=int, default=5,
                   help="ordinal categories C for the polytomous families "
                        "(synthetic-{grm,gpcm} data / --irt-model grm|gpcm);"
                        " binary links ignore this")
    p.add_argument("--artificial-missing-perc", type=float, default=0.1,
                   help="fraction of observed cells hidden for imputation "
                        "eval")
    p.add_argument("--missing-rate", type=float, default=0.0,
                   help="synthetic MAR missingness at generation time")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the whole command "
                        "into DIR (a Chrome trace: open it in Perfetto)")
    p.add_argument("--no-compilation-cache", action="store_true",
                   help="accepted for the JAX CLI's commands; does nothing "
                        "here (the kernels are compiled once into "
                        "build/vibo_tpu_torch/, keyed by their sources)")


def _load(args):
    from vibo_tpu_torch.data import holdout_split, load_dataset, simulate_irt
    if args.dataset.startswith("synthetic-"):
        model = args.dataset.split("-", 1)[1]
        kw = ({"num_categories": args.num_categories}
              if model in _POLYTOMOUS else {})
        sim = simulate_irt(model, args.num_persons, args.num_items,
                           ability_dim=args.ability_dim, seed=args.seed,
                           missing_rate=args.missing_rate, **kw)
        ds = holdout_split(sim.response, sim.mask,
                           args.artificial_missing_perc, seed=args.seed,
                           name=args.dataset,
                           num_categories=sim.num_categories)
        return ds, sim
    ds = load_dataset(args.dataset, data_dir=args.data_dir,
                      holdout_frac=args.artificial_missing_perc,
                      seed=args.seed,
                      # gradescope --irt-model grm|gpcm: partial credit in C
                      # levels; binary links load binarized
                      num_categories=(
                          args.num_categories
                          if getattr(args, "irt_model", None)
                          in _POLYTOMOUS else None))
    return ds, None


def _categorical_table(irt_model: str, b) -> np.ndarray:
    """The family's table (grm: ordered thresholds; gpcm: cumulative steps)
    from the unconstrained coordinates, f32 on the host."""
    import torch

    from vibo_tpu_torch.ops import links
    return links.categorical_table(
        irt_model, torch.from_numpy(np.asarray(b, np.float32))).numpy()


def _train_mesh(args, dev):
    """`train --data-parallel` under torchrun (WORLD_SIZE > 1): this rank's
    process group (NCCL on the card, gloo with --cpu) and a students-only
    mesh over every rank, as the JAX CLI builds one over every device;
    None otherwise (one process trains without a mesh, as JAX does on one
    device)."""
    if not (args.data_parallel and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        return None
    from vibo_tpu_torch import parallel
    dev = parallel.rank_device(cpu=dev.type == "cpu")
    parallel.init_distributed(dev)
    return parallel.make_mesh(device=dev)


def cmd_train(args):
    import torch

    from vibo_tpu_torch import evaluation
    from vibo_tpu_torch._device import resolve_device
    from vibo_tpu_torch.convert import params_to_numpy
    from vibo_tpu_torch.models import VIBO, VIBOConfig
    from vibo_tpu_torch.train import Trainer, TrainConfig
    from vibo_tpu_torch.utils.prof import peak_hbm_bytes

    dev = resolve_device(_device(args))
    mesh = _train_mesh(args, dev)
    if mesh is not None:
        dev = mesh.device
    ds, sim = _load(args)
    test_ds = None
    if args.eval_new_persons > 0:
        from vibo_tpu_torch.data.masking import split_persons
        ds, test_ds = split_persons(ds, test_frac=args.eval_new_persons,
                                    seed=args.seed)
    test_items_ds = None
    if getattr(args, "eval_new_items", 0) > 0:
        if not getattr(args, "item_encoder", False):
            raise SystemExit("--eval-new-items requires --item-encoder "
                             "(the free-form item posterior cannot score "
                             "unseen items)")
        if test_ds is not None:
            raise SystemExit(
                "--eval-new-items cannot be combined with "
                "--eval-new-persons: the item split changes num_items and "
                "the held-out persons' matrix would no longer match the "
                "model (run the two evals separately)")
        from vibo_tpu_torch.data.masking import split_items
        ds, test_items_ds = split_items(ds, test_frac=args.eval_new_items,
                                        seed=args.seed)
    n, m = ds.shape
    if (ds.num_categories > 2) != (args.irt_model in _POLYTOMOUS):
        raise SystemExit(
            f"dataset has {ds.num_categories} response categories but "
            f"--irt-model {args.irt_model}: polytomous data needs grm/gpcm, "
            f"binary data a binary link (1pl/2pl/3pl/deep)")
    model = VIBO(VIBOConfig(
        num_items=m, irt_model=args.irt_model, ability_dim=args.ability_dim,
        num_categories=ds.num_categories,
        hidden_dim=args.hidden_dim,
        conditional_posterior=not args.mean_field,
        condition_on=getattr(args, "condition_on", "sample"),
        theta_posterior=getattr(args, "theta_posterior", "diag"),
        item_encoder=getattr(args, "item_encoder", False),
        item_latent_dim=args.item_latent_dim,
        # the card's kernels for the linear and polytomous links (the f32
        # first layer and the link's one-pass loglik); deep keeps the plain
        # route, as the JAX CLI leaves it
        use_pallas=(dev.type == "cuda" and args.irt_model in _FAMILIES)),
        device=dev)
    trainer = Trainer(model, TrainConfig(
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        num_mc_samples=args.num_posterior_samples, seed=args.seed,
        eval_every=args.eval_every, out_dir=args.out_dir,
        objective=getattr(args, "objective", "elbo"),
        warm_start=getattr(args, "warm_start", None),
        restarts=getattr(args, "restarts", 1)), device=dev, mesh=mesh)
    res = trainer.fit(
        ds, truth=sim if (test_ds is None and test_items_ds is None) else None,
        resume=getattr(args, "resume", None))
    params = res["params"]
    if mesh is not None:
        # rank 0 evaluates and prints; the params are the same on every rank
        torch.distributed.destroy_process_group()
        if mesh.rank != 0:
            return None

    summary = {"dataset": ds.name, "shape": list(ds.shape),
               "irt_model": args.irt_model,
               "final_elbo": res["final_elbo"],
               **({"selected_restart": res["selected_restart"],
                   "restarts": res["restarts"]} if "restarts" in res else {}),
               "train_seconds": round(res["train_seconds"], 3),
               "warm_train_seconds": round(
                   res.get("warm_train_seconds", res["train_seconds"]), 3),
               "cells_per_sec": round(res["cells_per_sec"], 1),
               "best": res["best"]}
    hbm = peak_hbm_bytes(dev)
    if hbm is not None:
        summary["peak_hbm_mb"] = round(hbm / 2**20, 1)
    item_mean = evaluation.full_item_mean(model, params, ds)
    ev = evaluation.imputation_accuracy(model, params, ds,
                                        item_mean=item_mean)
    summary["heldout_acc"] = round(ev["acc"], 4)
    summary["heldout_base_rate"] = round(ev["base_rate"], 4)
    cal = evaluation.calibration(model, params, ds, item_mean=item_mean)
    summary["ece"] = round(cal["ece"], 4)
    summary["brier"] = round(cal["brier"], 4)
    if args.iwae_samples:
        on = getattr(args, "iwae_on", "heldout")
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        iw = evaluation.iwae_loglik(model, params, ds,
                                    num_samples=args.iwae_samples, on=on,
                                    generator=gen)
        summary["iwae_loglik_per_cell"] = round(iw["loglik_per_cell"], 5)
        summary["iwae_samples"] = args.iwae_samples
        summary["iwae_on"] = on
    if test_ds is not None:
        ev_new = evaluation.amortized_new_person_eval(model, params, test_ds)
        summary["new_person_acc"] = round(ev_new["acc"], 4)
        summary["new_person_base_rate"] = round(ev_new["base_rate"], 4)
        summary["new_persons_per_sec"] = round(ev_new["persons_per_sec"], 1)
    if test_items_ds is not None:
        ev_ni = evaluation.amortized_new_item_eval(model, params, ds,
                                                   test_items_ds)
        summary["new_item_acc"] = round(ev_ni["acc"], 4)
        summary["new_item_base_rate"] = round(ev_ni["base_rate"], 4)
        summary["num_new_items"] = ev_ni["num_new_items"]
    if args.irt_model == "deep":
        # the trained decoder, for the deep HMC gold posterior (compare
        # hands it to baseline --method hmc); underscore keys are kept out
        # of the printed summary
        summary["_deep_link"] = params_to_numpy(params["deep_link"])
    if test_ds is None and test_items_ds is None:
        # sim-truth and cross-method agreement only on the unsplit matrix;
        # a full-covariance family (chol or laplace at K > 1) also hands
        # on its scale tril for sigma_vs_hmc's frame transport
        chol = model.cfg.theta_posterior != "diag" and args.ability_dim > 1
        out_means = evaluation.infer_posterior_means(
            model, params, ds, return_sigma=True, return_scale_tril=chol)
        theta_hat, items, theta_sigma = out_means[:3]
        summary["_theta_hat"] = theta_hat
        summary["_theta_sigma"] = theta_sigma
        if chol:
            summary["_theta_scale_tril"] = out_means[3]
        if "b" in items:
            summary["_b_hat"] = np.asarray(items["b"])
        if "a" in items:
            summary["_a_hat"] = np.asarray(items["a"])
        # Laplace (Fisher) width at the amortized mean
        _, lap_tril = evaluation.laplace_theta_sigma(
            model, params, ds, theta=theta_hat, return_factor=True)
        summary["_theta_laplace_tril"] = lap_tril
        if getattr(args, "refine_theta", 0):
            mu_r, _, tril_r, rinfo = evaluation.refine_theta_posterior(
                model, params, ds, steps=args.refine_theta)
            summary["_theta_hat_refined"] = mu_r
            summary["_theta_scale_tril_refined"] = tril_r
            summary["refine_elbo_gain_per_person"] = round(
                rinfo["elbo_gain_per_person"], 5)
        if sim is not None:
            summary["theta_pearson"] = round(evaluation.correlation(
                theta_hat[:sim.theta.shape[0]], sim.theta,
                align_rotation=True)["pearson"], 4)
            if "b" in items and args.irt_model in _POLYTOMOUS:
                # the family's table (grm: ordered thresholds vs sim.b;
                # gpcm: cumulative steps vs cumsum of sim.b's steps)
                kappa_hat = _categorical_table(
                    args.irt_model, items["b"])[:sim.b.shape[0]]
                sim_tab = (sim.b if args.irt_model == "grm"
                           else np.cumsum(sim.b, -1))
                summary["b_pearson"] = round(evaluation.correlation(
                    kappa_hat.ravel(), sim_tab.ravel())["pearson"], 4)
            elif "b" in items:
                summary["b_pearson"] = round(evaluation.correlation(
                    items["b"][:sim.b.shape[0], 0], sim.b)["pearson"], 4)
    print(json.dumps(_public(summary)))
    return summary


def _public(summary: dict) -> dict:
    """Printed view of a summary: without the underscore-keyed arrays that
    exist for cross-method agreement inside cmd_compare."""
    return {k: v for k, v in summary.items() if not k.startswith("_")}


def _params_fingerprint(tree) -> str:
    """Short digest of a param tree's values: the f32 bytes of its leaves in
    sorted-key order (convert.tree_leaves, JAX's tree_flatten order), so
    both packages give one digest for the same weights; it validates that a
    cached deep HMC gold was sampled under THIS decoder."""
    from vibo_tpu_torch.convert import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.asarray(leaf, np.float32).tobytes())
    return h.hexdigest()[:16]


def cmd_baseline(args):
    from vibo_tpu_torch import evaluation
    dev = _device(args)
    ds, sim = _load(args)

    def impute_acc(prob):
        h = ds.heldout_mask
        if h.sum() == 0:
            return None
        if prob.ndim == 3:                   # grm/gpcm: (N, M, C)
            pred = prob.argmax(-1).astype(np.float32)
            cal = evaluation.calibration_from_category_probs(
                prob, ds.response, h)
        else:
            pred = (prob > 0.5).astype(np.float32)
            cal = evaluation.calibration_from_probs(prob, ds.response, h)
        summary["ece"] = round(cal["ece"], 4)
        summary["brier"] = round(cal["brier"], 4)
        return float((h * (pred == ds.response)).sum() / h.sum())

    summary = {"dataset": ds.name, "shape": list(ds.shape),
               "method": args.method}
    if args.irt_model == "deep" and args.method != "hmc":
        raise SystemExit(
            "the deep link has no closed-form MLE/EM baseline (nonlinear "
            "decoder); only --method hmc samples it, under a trained decoder")
    if args.irt_model != "deep" and \
            (ds.num_categories > 2) != (args.irt_model in _POLYTOMOUS):
        raise SystemExit(
            f"dataset has {ds.num_categories} response categories but "
            f"--irt-model {args.irt_model}: polytomous data needs grm/gpcm, "
            f"binary data a binary link")
    deep_params = None
    if args.method in ("mle", "map"):
        from vibo_tpu_torch.models import mle
        cfg = mle.MLEConfig(irt_model=args.irt_model,
                            ability_dim=args.ability_dim,
                            num_categories=ds.num_categories,
                            map_prior=(args.method == "map"),
                            steps=args.steps, seed=args.seed)
        params_t, loss = mle.fit_mle(ds.response, ds.train_mask, cfg,
                                     device=dev)
        params = {k: v.cpu().numpy() for k, v in params_t.items()}
        summary["final_loss"] = loss
        summary["heldout_acc"] = impute_acc(
            mle.response_prob(params_t, cfg).cpu().numpy())
        summary["_theta_hat"] = params["theta"]
        summary["_b_hat"] = params["b"]
        if "a" in params:
            summary["_a_hat"] = params["a"]
        if sim is not None:
            summary["theta_pearson"] = round(evaluation.correlation(
                params["theta"], sim.theta,
                align_rotation=True)["pearson"], 4)
    elif args.method == "em":
        from vibo_tpu_torch.models import em
        # 2PL EM is multidimensional (tensor-product grid, K <= 4); the
        # other families stay at the classical K = 1
        em_dim = args.ability_dim if args.irt_model == "2pl" else 1
        res = em.fit_em(ds.response, ds.train_mask,
                        em.EMConfig(irt_model=args.irt_model,
                                    ability_dim=em_dim, seed=args.seed,
                                    num_categories=ds.num_categories),
                        device=dev)
        summary["log_marginal"] = res["log_marginal"]
        summary["iterations"] = res["iterations"]
        summary["heldout_acc"] = impute_acc(em.response_prob(res, device=dev))
        theta = res["theta_eap"]
        summary["_theta_hat"] = theta[:, None] if theta.ndim == 1 else theta
        summary["_b_hat"] = np.asarray(res["b"])
        if "a" in res:
            summary["_a_hat"] = np.asarray(res["a"])
        if sim is not None:
            if em_dim > 1:
                summary["theta_pearson"] = round(evaluation.correlation(
                    theta, sim.theta, align_rotation=True)["pearson"], 4)
            else:
                summary["theta_pearson"] = round(evaluation.correlation(
                    theta, sim.theta[:, 0])["pearson"], 4)
    elif args.method == "hmc":
        from vibo_tpu_torch.models import hmc
        deep_params = getattr(args, "deep_params", None)
        if args.irt_model == "deep" and deep_params is None:
            ckpt_path = getattr(args, "deep_ckpt", None)
            if not ckpt_path:
                raise SystemExit(
                    "--irt-model deep HMC samples under a TRAINED decoder: "
                    "pass --deep-ckpt (a best.npz from `train ... --irt-model"
                    " deep --out-dir ...`) or run it via `compare`")
            from vibo_tpu_torch.convert import params_to_numpy
            from vibo_tpu_torch.serve import AbilityScorer
            scorer = AbilityScorer.from_checkpoint(ckpt_path, device=dev)
            deep_params = params_to_numpy(scorer.params["deep_link"])
        cfg = hmc.HMCConfig(irt_model=args.irt_model,
                            ability_dim=args.ability_dim,
                            num_categories=ds.num_categories,
                            num_warmup=args.hmc_warmup,
                            num_samples=args.hmc_samples, seed=args.seed,
                            num_chains=getattr(args, "hmc_chains", 4),
                            num_leapfrog=getattr(args, "hmc_leapfrog", 20),
                            trajectory=getattr(args, "hmc_trajectory",
                                               "fixed"),
                            max_tree_depth=getattr(args, "hmc_tree_depth", 8),
                            target_accept=getattr(args, "hmc_target_accept",
                                                  0.8))
        out = hmc.run_hmc(ds.response, ds.train_mask, cfg,
                          deep_params=deep_params, device=dev)
        diag = out["diagnostics"]
        summary["accept_rate"] = round(out["accept_rate"], 3)
        summary["step_size"] = round(out["step_size"], 5)
        summary["num_chains"] = diag["num_chains"]
        summary["rhat_max"] = round(diag["rhat_max"], 4)
        summary["ess_min"] = round(diag["ess_min"], 1)
        summary["divergences"] = diag["divergences"]
        summary["init_mode"] = diag["init_mode"]
        summary["trajectory"] = diag["trajectory"]
        if np.isfinite(diag.get("theta_sd_split_half_r", float("nan"))):
            summary["theta_sd_split_half_r"] = round(
                diag["theta_sd_split_half_r"], 4)
        summary["leapfrogs_per_draw"] = round(diag["leapfrogs_per_draw"], 1)
        summary["converged"] = bool(diag["rhat_max"] <= 1.05
                                    and diag["divergences"] == 0)
        if not summary["converged"]:
            print(f"WARNING: HMC convergence diagnostics FAILED "
                  f"(split-R-hat max {diag['rhat_max']:.3f} > 1.05 or "
                  f"{diag['divergences']} divergences) — do not treat these "
                  f"samples as a gold posterior; increase --hmc-warmup/"
                  f"--hmc-samples", file=sys.stderr)
        summary["heldout_acc"] = impute_acc(
            hmc.posterior_mean_prob(out["samples"], args.irt_model,
                                    deep_params=deep_params, device=dev))
        samples = out["samples"]
        summary["_theta_hat"] = np.asarray(samples["theta"].mean(0))
        summary["_theta_sd"] = np.asarray(samples["theta"].std(0))
        if "b" in samples:
            summary["_b_hat"] = np.asarray(samples["b"].mean(0))
        if "a" in samples:
            summary["_a_hat"] = np.asarray(samples["a"].mean(0))
        if sim is not None:
            summary["theta_pearson"] = round(evaluation.correlation(
                summary["_theta_hat"], sim.theta,
                align_rotation=True)["pearson"], 4)
    else:
        raise SystemExit(f"unknown method {args.method}")
    if getattr(args, "out_dir", None):
        # the posterior summary as a reusable artifact (compare --hmc-cache
        # reloads it): every underscore array, in the JAX package's keys
        os.makedirs(args.out_dir, exist_ok=True)
        arrays = {k[1:]: np.asarray(v) for k, v in summary.items()
                  if k.startswith("_") and isinstance(v, np.ndarray)}
        if args.method == "hmc" and args.irt_model == "deep":
            # a deep posterior is reusable only under byte-identical decoder
            # weights
            arrays["deep_fingerprint"] = np.asarray(
                _params_fingerprint(deep_params))
        np.savez(os.path.join(args.out_dir, f"baseline_{args.method}.npz"),
                 summary_json=json.dumps(_public(summary)),
                 dataset=ds.name, shape=np.asarray(ds.shape),
                 seed=args.seed, **arrays)
    print(json.dumps(_public(summary)))
    return summary


def _cached_hmc_row(args, first_row: dict):
    """The HMC row from `--hmc-cache DIR/baseline_hmc.npz` (a
    `baseline --method hmc --out-dir` of either package, or a cache miss
    written through here), validated against this run's dataset, shape and
    seed, and a deep gold against this run's decoder fingerprint (a
    mismatch raises SystemExit). All four summaries the cache holds come
    back (theta_hat, theta_sd, b_hat, a_hat), so a cached row gives the item
    agreements too. None when there is no cache."""
    if not getattr(args, "hmc_cache", None):
        return None
    path = os.path.join(args.hmc_cache, "baseline_hmc.npz")
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        row = json.loads(str(z["summary_json"]))
        shape = [int(x) for x in z["shape"]]
        if (row.get("dataset") != first_row["dataset"]
                or shape != [int(x) for x in first_row["shape"]]
                or int(z["seed"]) != args.seed):
            raise SystemExit(
                f"--hmc-cache {path} was sampled on "
                f"{row.get('dataset')}{shape} seed "
                f"{int(z['seed'])}, not this run's "
                f"{first_row['dataset']}{first_row['shape']} seed "
                f"{args.seed} — posterior reuse would be invalid")
        if "deep_fingerprint" in z.files:
            cur = (_params_fingerprint(first_row["_deep_link"])
                   if "_deep_link" in first_row else None)
            if str(z["deep_fingerprint"]) != cur:
                raise SystemExit(
                    f"--hmc-cache {path} holds a DEEP gold posterior "
                    f"sampled under decoder {z['deep_fingerprint']}, "
                    f"but this run's trained decoder is {cur} — a deep "
                    f"posterior is only reusable under byte-identical "
                    f"decoder weights; delete the cache or retrain "
                    f"deterministically")
        for k in ("theta_hat", "theta_sd", "b_hat", "a_hat"):
            if k in z.files:
                row["_" + k] = z[k]
    row["method"] = "hmc"
    row["seconds"] = 0.0
    row["cached"] = True
    return row


def cmd_compare(args):
    """Parity sweep: VIBO and every baseline on the same dataset and split,
    with held-out accuracy, theta recovery, cross-method agreement against
    the HMC posterior and wall-clock seconds side by side."""
    rows = []

    def timed(label, fn):
        t0 = time.perf_counter()
        summary = fn()
        summary["method"] = label
        summary["seconds"] = round(time.perf_counter() - t0, 3)
        rows.append(summary)

    vibo_args = argparse.Namespace(**vars(args))
    vibo_args.iwae_samples = getattr(args, "iwae_samples", 0)
    vibo_args.mean_field = getattr(args, "mean_field", False)
    vibo_args.eval_new_persons = 0.0
    vibo_args.data_parallel = False
    vibo_args.batch_size = None
    vibo_args.num_posterior_samples = getattr(args, "num_posterior_samples", 1)
    vibo_args.restarts = getattr(args, "restarts", 1)
    vibo_args.hidden_dim = args.hidden_dim
    vibo_args.item_latent_dim = 16
    vibo_args.lr = 5e-3
    vibo_args.eval_every = max(args.epochs // 4, 1)
    timed("vibo", lambda: cmd_train(vibo_args))

    for method in args.methods.split(","):
        method = method.strip()
        if method in ("", "vibo"):
            continue
        if method == "hmc":
            cached = _cached_hmc_row(args, rows[0])
            if cached is not None:
                print(f"note: hmc row loaded from --hmc-cache "
                      f"{args.hmc_cache} (no re-sampling)", file=sys.stderr)
                rows.append(cached)
                continue
        b_args = argparse.Namespace(**vars(args))
        b_args.method = method
        # write-through: a cache miss populates the cache for next time
        b_args.out_dir = (args.hmc_cache
                          if method == "hmc" and getattr(args, "hmc_cache",
                                                         None)
                          else None)
        if args.irt_model in _FAMILIES:
            b_args.irt_model = args.irt_model
        elif method == "hmc":
            # deep: HMC samples (theta, d) under the decoder VIBO trained
            b_args.irt_model = "deep"
            b_args.deep_params = rows[0]["_deep_link"]
        else:
            print("NOTE: the deep link has no MLE/EM analog; running the "
                  f"{method} baseline as 2PL", file=sys.stderr)
            b_args.irt_model = "2pl"
        if (method == "em" and args.ability_dim > 1
                and (b_args.irt_model != "2pl" or args.ability_dim > 4)):
            b_args.ability_dim = 1
            print(f"NOTE: {b_args.irt_model} EM is K=1 by classical "
                  f"restriction (models/em.py); comparing its single trait "
                  f"against ability-dim={args.ability_dim} methods via the "
                  f"mean multiple correlation", file=sys.stderr)
        timed(method, lambda: cmd_baseline(b_args))

    _agreement_vs_hmc(args, rows)
    cols = ("method", "seconds", "heldout_acc", "ece", "theta_pearson",
            "theta_vs_hmc", "sigma_vs_hmc", "laplace_sigma_vs_hmc",
            "b_vs_hmc", "a_vs_hmc",
            "refined_theta_vs_hmc", "refined_sigma_vs_hmc",
            "refine_elbo_gain_per_person",
            "rhat_max", "converged", "cached", "dim_note")
    table = [{c: r[c] for c in cols if c in r} for r in rows]
    print(json.dumps({"dataset": rows[0]["dataset"], "compare": table}))
    return table


def _agreement_vs_hmc(args, rows: list) -> None:
    """Cross-method posterior agreement against the HMC row, in place: each
    method's theta means (theta_vs_hmc; Procrustes-aligned, or the mean
    multiple correlation across unequal ability dims), its posterior and
    Laplace widths (sigma_vs_hmc, laplace_sigma_vs_hmc; at K > 1 the
    covariance transported into HMC's frame by the means' rotation), the
    refined posterior's, and the item means (b_vs_hmc on the family's
    table; a_vs_hmc through the means' rotation)."""
    from vibo_tpu_torch import evaluation
    hmc_row = next((r for r in rows if r["method"] == "hmc"), None)
    if hmc_row is None or "_theta_hat" not in hmc_row:
        return
    ref = hmc_row["_theta_hat"]
    for r in rows:
        if r is hmc_row or "_theta_hat" not in r:
            continue
        r_hat = np.asarray(r["_theta_hat"])
        if r_hat.ndim == 1:
            r_hat = r_hat[:, None]
        if r_hat.shape[1] != ref.shape[1]:
            lo, hi = ((r_hat, ref) if r_hat.shape[1] < ref.shape[1]
                      else (ref, r_hat))
            r["theta_vs_hmc"] = round(float(np.mean(
                [evaluation.multiple_correlation(lo[:, d], hi)
                 for d in range(lo.shape[1])])), 4)
            r["dim_note"] = (
                f"K={r_hat.shape[1]} {r['method']} vs K={ref.shape[1]} "
                "hmc: multiple correlation, not rotation-aligned Pearson")
            print(f"note: {r['dim_note']}", file=sys.stderr)
        else:
            r["theta_vs_hmc"] = round(evaluation.correlation(
                r_hat, ref, align_rotation=True)["pearson"], 4)
        if "_theta_sigma" in r and "_theta_sd" in hmc_row:
            sig = np.asarray(r["_theta_sigma"])
            if sig.ndim == 2 and sig.shape[1] == ref.shape[1] > 1:
                # the covariance transported into the HMC frame by the
                # means' rotation: a full-covariance family's whole factor,
                # the diagonal family's diagonal
                w = evaluation.procrustes_rotation(r_hat, ref)
                sig = (evaluation.rotate_tril_sigma(
                    np.asarray(r["_theta_scale_tril"]), w)
                    if "_theta_scale_tril" in r
                    else evaluation.rotate_diag_sigma(sig, w))
            r["sigma_vs_hmc"] = round(evaluation.correlation(
                sig, hmc_row["_theta_sd"])["pearson"], 4)
        if "_theta_laplace_tril" in r and "_theta_sd" in hmc_row:
            lap = np.asarray(r["_theta_laplace_tril"])
            if ref.ndim == 2 and ref.shape[1] > 1 and r_hat.ndim == 2 \
                    and r_hat.shape[1] == ref.shape[1]:
                w = evaluation.procrustes_rotation(r_hat, ref)
                lap_sd = evaluation.rotate_tril_sigma(lap, w)
            else:
                lap_sd = np.sqrt((lap ** 2).sum(-1))
            r["laplace_sigma_vs_hmc"] = round(evaluation.correlation(
                lap_sd, hmc_row["_theta_sd"])["pearson"], 4)
        if "_theta_hat_refined" in r and "_theta_sd" in hmc_row:
            mu_r = np.asarray(r["_theta_hat_refined"])
            tr_r = np.asarray(r["_theta_scale_tril_refined"])
            r["refined_theta_vs_hmc"] = round(evaluation.correlation(
                mu_r, ref, align_rotation=True)["pearson"], 4)
            if ref.ndim == 2 and ref.shape[1] > 1 \
                    and mu_r.shape[1] == ref.shape[1]:
                w = evaluation.procrustes_rotation(mu_r, ref)
                sd_r = evaluation.rotate_tril_sigma(tr_r, w)
            else:
                sd_r = np.sqrt((tr_r ** 2).sum(-1))
            r["refined_sigma_vs_hmc"] = round(evaluation.correlation(
                sd_r, hmc_row["_theta_sd"])["pearson"], 4)
        if "_b_hat" in r and "_b_hat" in hmc_row:
            b_r = np.asarray(r["_b_hat"])
            b_ref = np.asarray(hmc_row["_b_hat"])
            if args.irt_model in _POLYTOMOUS:
                b_r = _categorical_table(args.irt_model, b_r)
                b_ref = _categorical_table(args.irt_model, b_ref)
            if b_r.size == b_ref.size:
                r["b_vs_hmc"] = round(evaluation.correlation(
                    b_r.ravel(), b_ref.ravel())["pearson"], 4)
        if ("_a_hat" in r and "_a_hat" in hmc_row
                and r_hat.shape == ref.shape):
            a_r = np.asarray(r["_a_hat"])
            a_ref = np.asarray(hmc_row["_a_hat"])
            if a_r.ndim == 1:
                a_r = a_r[:, None]
            if a_ref.ndim == 1:
                a_ref = a_ref[:, None]
            if a_r.shape == a_ref.shape:
                w = evaluation.procrustes_rotation(r_hat, ref)
                r["a_vs_hmc"] = round(evaluation.correlation(
                    (a_r @ w).ravel(), a_ref.ravel())["pearson"], 4)
    hmc_row["theta_vs_hmc"] = 1.0
    if "_b_hat" in hmc_row:
        hmc_row["b_vs_hmc"] = 1.0
    if "_a_hat" in hmc_row:
        hmc_row["a_vs_hmc"] = 1.0


def _read_score_input(args, num_items, vocab):
    """-> (person_ids, response (B, M) f32, mask (B, M) f32, n_unknown).

    .npz input: `response` (B, M) and an optional `mask` (default: every
    cell observed). .csv input: long format, one row per observed response;
    item ids map through the checkpoint's vocabulary when it has one, else
    they must be integer column indices 0..M-1 (others are counted as
    unknown and dropped)."""
    import csv as _csv

    if args.input.endswith(".npz"):
        with np.load(args.input) as data:
            response = np.asarray(data["response"], np.float32)
            mask = (np.asarray(data["mask"], np.float32) if "mask" in data
                    else np.ones_like(response))
        if response.ndim != 2 or response.shape[1] != num_items:
            raise ValueError(
                f"{args.input}: response must be (B, {num_items}), "
                f"got {response.shape}")
        pids = [str(k) for k in range(response.shape[0])]
        return pids, response, mask, 0

    by_person: dict[str, dict[int, float]] = {}
    unknown = 0
    with open(args.input, newline="") as f:
        for row in _csv.DictReader(f):
            iid = row[args.item_col]
            if vocab is not None:
                j = vocab.get(iid)
                if j is None:
                    unknown += 1
                    continue
            else:
                try:
                    j = int(iid)
                except ValueError:
                    raise ValueError(
                        f"item id {iid!r} is not an integer column index and "
                        f"the checkpoint embeds no item vocabulary (train "
                        "via cli train on a real CSV to embed one)")
                if not 0 <= j < num_items:
                    unknown += 1
                    continue
            by_person.setdefault(row[args.person_col], {})[j] = \
                float(row[args.correct_col])
    if not by_person:
        raise ValueError(f"{args.input}: no scorable responses")
    pids = sorted(by_person)
    response = np.zeros((len(pids), num_items), np.float32)
    mask = np.zeros_like(response)
    for b, p in enumerate(pids):
        for j, c in by_person[p].items():
            response[b, j] = 1.0 if c > 0.5 else 0.0
            mask[b, j] = 1.0
    return pids, response, mask, unknown


def _score_items(args, scorer) -> dict:
    """score --items: the item encoder's cold-start posteriors of the
    unseen items in --input (an .npz of response and, optionally, mask;
    its columns are the new items), as the JAX CLI gives them."""
    with np.load(args.input) as data:
        response = np.asarray(data["response"], np.float32)
        mask = (np.asarray(data["mask"], np.float32) if "mask" in data
                else np.ones_like(response))
    t0 = time.perf_counter()
    out = scorer.score_items(response, mask)
    summary = {"checkpoint": args.checkpoint, "mode": "items",
               "num_new_items": int(response.shape[1]),
               "seconds": round(time.perf_counter() - t0, 3),
               "params": sorted(out)}
    if args.output:
        np.savez(args.output, **out)
        summary["output"] = args.output
    print(json.dumps(summary))
    return summary


def cmd_score(args):
    """Serving: batched amortized scoring of new students from a trained
    checkpoint (either package's; serve.AbilityScorer), in batches of
    --batch-size, optionally refined per person (--refine-theta)."""
    from vibo_tpu_torch.serve import AbilityScorer
    from vibo_tpu_torch.train import checkpoint as ckpt_mod

    scorer = AbilityScorer.from_checkpoint(args.checkpoint,
                                           device=_device(args))
    if args.items:
        return _score_items(args, scorer)
    num_items = scorer.model.cfg.num_items
    extra = ckpt_mod.peek_extra(args.checkpoint)
    vocab = None
    if "item_ids" in extra:
        vocab = {iid: j for j, iid in
                 enumerate(json.loads(str(extra["item_ids"])))}

    pids, response, mask, unknown = _read_score_input(args, num_items, vocab)
    if unknown:
        print(f"note: dropped {unknown} response(s) to items outside the "
              "trained vocabulary", file=sys.stderr)
    t0 = time.perf_counter()
    bs = max(1, args.batch_size)
    outs = [scorer.score(response[s:s + bs], mask[s:s + bs])
            for s in range(0, response.shape[0], bs)]
    out = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    if getattr(args, "refine_theta", 0):
        routs = [scorer.refine(response[s:s + bs], mask[s:s + bs],
                               steps=args.refine_theta)
                 for s in range(0, response.shape[0], bs)]
        for k in ("theta_mu", "theta_sigma", "theta_tril"):
            out["refined_" + k] = np.concatenate([o[k] for o in routs])
    seconds = time.perf_counter() - t0
    summary = {"checkpoint": args.checkpoint, "mode": "persons",
               "num_persons": len(pids),
               "num_unknown_item_responses": unknown,
               "seconds": round(seconds, 3),
               "persons_per_sec": round(len(pids) / max(seconds, 1e-9), 1),
               "theta_mu_mean": [round(v, 4) for v in
                                 np.mean(out["theta_mu"], 0).tolist()],
               "theta_sigma_mean": [round(v, 4) for v in
                                    np.mean(out["theta_sigma"], 0).tolist()]}
    if args.output:
        np.savez(args.output, person_ids=np.asarray(pids), **out)
        summary["output"] = args.output
    print(json.dumps(summary))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="vibo_tpu_torch",
        description="VIBO variational IRT on PyTorch (the card by default)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train + evaluate a VIBO model")
    _add_common(t)
    t.add_argument("--irt-model", default="2pl",
                   choices=["1pl", "2pl", "3pl", "grm", "gpcm", "deep"])
    t.add_argument("--hidden-dim", type=int, default=256)
    t.add_argument("--item-latent-dim", type=int, default=16)
    t.add_argument("--lr", type=float, default=5e-3)
    t.add_argument("--epochs", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--num-posterior-samples", type=int, default=1,
                   help="MC samples for the training objective")
    t.add_argument("--restarts", type=int, default=1,
                   help="independent random restarts; keeps the best final "
                        "training bound (TrainConfig.restarts)")
    t.add_argument("--refine-theta", type=int, default=0, metavar="STEPS",
                   dest="refine_theta",
                   help="semi-amortized eval: per-person SVI refinement of "
                        "q(theta) for STEPS Adam steps from the amortized "
                        "posterior (evaluation.refine_theta_posterior)")
    t.add_argument("--objective", default="elbo", choices=["elbo", "iwae"],
                   help="training bound: ELBO or the multi-sample IWAE")
    t.add_argument("--warm-start", default=None, metavar="CKPT",
                   dest="warm_start",
                   help="transplant a trained checkpoint's params into this "
                        "model before training (checkpoint.transplant_params)")
    t.add_argument("--iwae-samples", type=int, default=0,
                   help="if >0, evaluate the IWAE-S test log-lik")
    t.add_argument("--iwae-on", default="heldout",
                   choices=["heldout", "train"],
                   help="cells the IWAE bound scores")
    t.add_argument("--eval-every", type=int, default=50)
    t.add_argument("--mean-field", action="store_true",
                   help="ablation: q(theta|r) without item conditioning")
    t.add_argument("--theta-posterior", default="diag",
                   choices=["diag", "chol", "laplace", "laplace-w"],
                   dest="theta_posterior",
                   help="ability-posterior covariance family: independent "
                        "per-dim Gaussians, full covariance by a Cholesky "
                        "head, or the Fisher-anchored covariance "
                        "(unweighted, or weighted by the expected Fisher "
                        "weight at the head's mean)")
    t.add_argument("--condition-on", default="sample",
                   choices=["sample", "mean", "stats"], dest="condition_on",
                   help="conditional posterior input: the item draw, the "
                        "item-posterior means, or the draw's sufficient "
                        "statistics")
    t.add_argument("--item-encoder", action="store_true",
                   help="amortize q(d_j|r_col) from column statistics "
                        "(enables new-item cold start) instead of free "
                        "per-item Gaussians")
    t.add_argument("--eval-new-items", type=float, default=0.0,
                   help="hold out this fraction of ITEMS and score them "
                        "cold-start (requires --item-encoder)")
    t.add_argument("--eval-new-persons", type=float, default=0.0,
                   help="hold out this fraction of persons and score the "
                        "amortized encoder on them")
    t.add_argument("--data-parallel", action="store_true",
                   help="shard students over every rank of a torchrun "
                        "world (torchrun --nproc_per_node N -m "
                        "vibo_tpu_torch.cli train ...); one process trains "
                        "without a mesh")
    t.add_argument("--resume", default=None,
                   help="checkpoint (.npz from --out-dir) to restore params/"
                        "optimizer/generator from before training further "
                        "epochs")
    t.set_defaults(fn=cmd_train)

    b = sub.add_parser("baseline", help="run an MLE/MAP/EM/HMC baseline")
    _add_common(b)
    b.add_argument("--method", required=True,
                   choices=["mle", "map", "em", "hmc"])
    b.add_argument("--irt-model", default="2pl",
                   choices=["1pl", "2pl", "3pl", "grm", "gpcm", "deep"])
    b.add_argument("--deep-ckpt", default=None,
                   help="--irt-model deep + --method hmc: checkpoint "
                        "(best.npz from a deep `train --out-dir`) whose "
                        "decoder weights the sampler holds fixed")
    b.add_argument("--steps", type=int, default=500)
    b.add_argument("--hmc-warmup", type=int, default=300)
    b.add_argument("--hmc-samples", type=int, default=300)
    b.add_argument("--hmc-chains", type=int, default=4)
    b.add_argument("--hmc-leapfrog", type=int, default=20,
                   help="leapfrog steps per trajectory")
    b.add_argument("--hmc-target-accept", type=float, default=0.8,
                   help="dual-averaging target acceptance")
    b.add_argument("--hmc-trajectory", default="fixed",
                   choices=["fixed", "nuts"], dest="hmc_trajectory",
                   help="fixed: --hmc-leapfrog steps with jitter; nuts: "
                        "dynamic No-U-Turn path lengths (models/hmc.py)")
    b.add_argument("--hmc-tree-depth", type=int, default=8,
                   dest="hmc_tree_depth",
                   help="nuts: max tree doublings per draw")
    b.set_defaults(fn=cmd_baseline)

    c = sub.add_parser("compare",
                       help="parity sweep: VIBO vs MLE/MAP/EM/HMC on one "
                            "dataset (accuracy, recovery, wall-clock)")
    _add_common(c)
    c.add_argument("--irt-model", default="2pl",
                   choices=["1pl", "2pl", "3pl", "grm", "gpcm", "deep"])
    c.add_argument("--methods", default="mle,em,hmc",
                   help="comma-separated baselines to include")
    c.add_argument("--hidden-dim", type=int, default=256)
    c.add_argument("--epochs", type=int, default=200)
    c.add_argument("--mean-field", action="store_true",
                   help="VIBO leg: q(theta|r) without item conditioning")
    c.add_argument("--condition-on", default="sample",
                   choices=["sample", "mean", "stats"], dest="condition_on",
                   help="VIBO leg: see train --condition-on")
    c.add_argument("--theta-posterior", default="diag",
                   choices=["diag", "chol", "laplace", "laplace-w"],
                   dest="theta_posterior",
                   help="VIBO leg: see train --theta-posterior")
    c.add_argument("--num-posterior-samples", type=int, default=1,
                   help="VIBO leg: MC samples for the training objective")
    c.add_argument("--objective", default="elbo", choices=["elbo", "iwae"],
                   help="VIBO leg: training bound (see train --objective)")
    c.add_argument("--warm-start", default=None, metavar="CKPT",
                   dest="warm_start",
                   help="VIBO leg: see train --warm-start")
    c.add_argument("--restarts", type=int, default=1,
                   help="VIBO leg: independent random restarts, best final "
                        "bound kept (TrainConfig.restarts)")
    c.add_argument("--refine-theta", type=int, default=0, metavar="STEPS",
                   dest="refine_theta",
                   help="VIBO leg: see train --refine-theta (adds "
                        "refined_theta_vs_hmc / refined_sigma_vs_hmc)")
    c.add_argument("--steps", type=int, default=500)
    c.add_argument("--hmc-warmup", type=int, default=300)
    c.add_argument("--hmc-samples", type=int, default=300)
    c.add_argument("--hmc-chains", type=int, default=4)
    c.add_argument("--hmc-leapfrog", type=int, default=20)
    c.add_argument("--hmc-target-accept", type=float, default=0.8)
    c.add_argument("--hmc-trajectory", default="fixed",
                   choices=["fixed", "nuts"], dest="hmc_trajectory")
    c.add_argument("--hmc-tree-depth", type=int, default=8,
                   dest="hmc_tree_depth")
    c.add_argument("--hmc-cache", default=None, metavar="DIR",
                   dest="hmc_cache",
                   help="reuse a gold posterior: load DIR/baseline_hmc.npz "
                        "(saved by `baseline --out-dir` of either package or "
                        "a previous cache miss here) instead of re-sampling; "
                        "validated against this run's dataset/shape/seed")
    c.set_defaults(fn=cmd_compare)

    s = sub.add_parser(
        "score",
        help="serving: amortized scoring of NEW students from a trained "
             "checkpoint — one encoder pass, no retraining")
    s.add_argument("--checkpoint", required=True,
                   help="best.npz written by `train --out-dir` of either "
                        "package (self-describing: embeds the model config "
                        "and, for real CSV datasets, the item-id vocabulary)")
    s.add_argument("--input", required=True,
                   help=".npz with `response` (B, M) [+ `mask`], or a "
                        "long-format .csv of (person, item, correct) rows")
    s.add_argument("--person-col", default="student_id")
    s.add_argument("--item-col", default="item_id")
    s.add_argument("--correct-col", default="correct")
    s.add_argument("--output", default=None,
                   help="write person_ids + theta_mu/theta_sigma/prob to "
                        "this .npz")
    s.add_argument("--items", action="store_true",
                   help="new-ITEM cold start: input columns (an .npz of "
                        "response and mask) are unseen items; needs a model "
                        "trained with --item-encoder")
    s.add_argument("--batch-size", type=int, default=4096)
    s.add_argument("--refine-theta", type=int, default=0, metavar="STEPS",
                   dest="refine_theta",
                   help="semi-amortized serving: SVI-refine q(theta) per "
                        "batch before output (AbilityScorer.refine)")
    s.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    s.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace into DIR")
    s.add_argument("--no-compilation-cache", action="store_true",
                   help=argparse.SUPPRESS)
    s.set_defaults(fn=cmd_score)

    args = ap.parse_args(argv)
    if getattr(args, "profile", None):
        from vibo_tpu_torch.utils.prof import trace
        with trace(args.profile):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    main()
