"""The port's command line (`vibo_tpu_torch.cli`, with --cpu) against the
JAX package's (`vibo_tpu.cli`) at small shapes (60-120 persons).

`train`: JAX's command trains; the port's gets those trained params
(converted) in place of its own fit, so every printed summary key must
agree with JAX's within one unit of its printed last digit and every
underscore array at 1e-5 (IWAE and refinement on JAX's replayed draws).
`baseline --method em` agrees at 1e-4. An HMC cache written by one
package's `baseline --method hmc --out-dir` is read by the other's
`compare`, which restores its theta, sd, b and a summaries (the port gives
b_vs_hmc and a_vs_hmc on a cached row, JAX does not); a dataset, shape,
seed or deep-decoder mismatch refuses the cache. `score` from a JAX-written
checkpoint (a CSV dataset, so with a vocabulary) equals JAX's from a long
CSV and from an .npz. `--profile` writes a trace. The posterior and
conditioning families (--theta-posterior chol/laplace/laplace-w,
--condition-on stats, --item-encoder with --eval-new-items) give JAX's
train summaries, and `score --items` JAX's cold-start posteriors from a
checkpoint of either package."""

import argparse
import csv
import glob
import json

import jax
import numpy as np
import pytest
import torch

from vibo_tpu import cli as jcli
from vibo_tpu import evaluation as jeval
from vibo_tpu.train import trainer as jtrainer
from vibo_tpu_torch import cli, evaluation
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.train import trainer

from jax_noise_replay import replay_noise

TIMING = {"new_persons_per_sec"}


def _decimals(v: float) -> int:
    text = json.dumps(v)
    return len(text.split(".")[1]) if "." in text and "e" not in text else 0


def _agree(got, want, key=""):
    """Equal, or within one unit of want's printed last digit."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), key
        for k in want:
            _agree(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            _agree(g, w, f"{key}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        tol = 10.0 ** -_decimals(want) * 1.0001
        assert abs(got - want) <= tol, (key, got, want)
    else:
        assert got == want, (key, got, want)


def _close(got, want, tol):
    got = [np.asarray(x, np.float64) for x in tree_leaves(got)]
    want = [np.asarray(x, np.float64) for x in
            jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, np.abs(g - w).max() / scale


def _summaries_agree(got, want, tol=1e-5):
    pub_g, pub_w = cli._public(got), jcli._public(want)
    assert pub_g.keys() == pub_w.keys()
    for k in pub_w:
        if k not in TIMING:
            _agree(pub_g[k], pub_w[k], k)
    under = sorted(k for k in want if k.startswith("_"))
    assert sorted(k for k in got if k.startswith("_")) == under
    for k in under:
        _close(got[k], want[k], tol)


def _jax_run(argv, monkeypatch, fits):
    """JAX's main(argv), each Trainer.fit result appended to `fits`."""
    orig = jtrainer.Trainer.fit

    def fit(self, *a, **kw):
        res = orig(self, *a, **kw)
        fits.append(res)
        return res
    monkeypatch.setattr(jtrainer.Trainer, "fit", fit)
    out = jcli.main(argv)
    monkeypatch.setattr(jtrainer.Trainer, "fit", orig)
    return out


def _port_fit_from(monkeypatch, res):
    """The port's Trainer.fit returns JAX's fit result, params converted."""
    def fit(self, ds, truth=None, resume=None):
        out = {k: v for k, v in res.items()
               if k in ("final_elbo", "train_seconds", "warm_train_seconds",
                        "cells_per_sec", "best", "selected_restart",
                        "restarts")}
        out["params"] = params_from_jax(
            jax.tree.map(np.asarray, res["params"]), self.device)
        return out
    monkeypatch.setattr(trainer.Trainer, "fit", fit)


def _replay_eval(monkeypatch, seed, jparams, k, steps=None):
    """Feed the port's IWAE (key seed + 1, split per block) and refinement
    (key(0), fold_in per block) JAX's draws."""
    items = jparams.get("item_post") or jparams["item_resid"]
    shapes = {name: tuple(np.shape(p["mu"])) for name, p in items.items()}
    orig_iwae = evaluation.iwae_loglik
    orig_refine = evaluation.refine_theta_posterior

    def iwae(model, params, ds, num_samples=100, on="heldout", **kw):
        state = {"key": jax.random.key(seed + 1)}

        def noise(_bi, rows):
            state["key"], sub = jax.random.split(state["key"])
            return replay_noise(sub, num_samples, shapes, rows, k)
        return orig_iwae(model, params, ds, num_samples=num_samples, on=on,
                         noise=noise)

    def refine(model, params, ds, steps=300, **kw):
        def noise(bi, rows):
            key = jax.random.fold_in(jax.random.key(0), bi)
            shape = (8, rows, k)
            eps = np.stack([np.asarray(jax.random.normal(kk, shape))
                            for kk in jax.random.split(key, steps)])
            last = np.asarray(jax.random.normal(
                jax.random.fold_in(key, steps + 1), shape))
            return torch.from_numpy(eps), torch.from_numpy(last)
        return orig_refine(model, params, ds, steps=steps, noise=noise)
    monkeypatch.setattr(evaluation, "iwae_loglik", iwae)
    monkeypatch.setattr(evaluation, "refine_theta_posterior", refine)


SMALL = ["--num-persons", "100", "--num-items", "16", "--epochs", "4",
         "--eval-every", "2", "--hidden-dim", "16"]


@pytest.mark.parametrize("argv,k", [
    (["synthetic-1pl", "--irt-model", "1pl", "--refine-theta", "3"], 1),
    (["synthetic-3pl", "--irt-model", "3pl", "--missing-rate", "0.2",
      "--iwae-samples", "6"], 1),
    (["synthetic-grm", "--irt-model", "grm", "--num-categories", "4",
      "--ability-dim", "2"], 2),
    (["synthetic-gpcm", "--irt-model", "gpcm", "--num-categories", "4"], 1),
    (["synthetic-nonlinear", "--irt-model", "deep", "--ability-dim", "2",
      "--item-latent-dim", "4", "--iwae-samples", "4"], 2),
    (["synthetic-2pl", "--eval-new-persons", "0.25", "--restarts", "2"], 1),
])
def test_train_summary_matches_jax(argv, k, monkeypatch):
    argv = ["train", *argv, *SMALL]
    fits = []
    want = _jax_run(argv, monkeypatch, fits)
    _port_fit_from(monkeypatch, fits[-1] if len(fits) == 1 else
                   {**fits[want["selected_restart"]],
                    "selected_restart": want["selected_restart"],
                    "restarts": want["restarts"]})
    _replay_eval(monkeypatch, 0, fits[0]["params"], k)
    got = cli.main([*argv, "--cpu"])
    _summaries_agree(got, want)


def test_baseline_em_matches_jax():
    argv = ["baseline", "synthetic-2pl", "--method", "em", "--num-persons",
            "120", "--num-items", "20"]
    want = jcli.main(argv)
    got = cli.main([*argv, "--cpu"])
    assert got["iterations"] == want["iterations"]
    assert got["log_marginal"] == pytest.approx(want["log_marginal"],
                                                rel=1e-4)
    for key in ("heldout_acc", "ece", "brier", "theta_pearson"):
        assert got[key] == pytest.approx(want[key], abs=1e-4)
    for key in ("_theta_hat", "_b_hat", "_a_hat"):
        _close(got[key], want[key], 1e-4)


HMC = ["--num-persons", "60", "--num-items", "12", "--hmc-warmup", "20",
       "--hmc-samples", "20", "--hmc-leapfrog", "8", "--hmc-chains", "2"]
VIBO_SMALL = ["--epochs", "4", "--hidden-dim", "16"]


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """One HMC cache written by each package's baseline."""
    tmp = tmp_path_factory.mktemp("hmc")
    argv = ["baseline", "synthetic-2pl", "--method", "hmc", *HMC]
    jcli.main([*argv, "--out-dir", str(tmp / "jax")])
    cli.main([*argv, "--out-dir", str(tmp / "port"), "--cpu"])
    return {"jax": str(tmp / "jax"), "port": str(tmp / "port")}


def test_hmc_caches_cross_packages(caches, monkeypatch, capsys):
    for side in ("jax", "port"):
        with np.load(f"{caches[side]}/baseline_hmc.npz") as z:
            assert {"summary_json", "dataset", "shape", "seed", "theta_hat",
                    "theta_sd", "b_hat", "a_hat"} <= set(z.files)
            assert all(z[k].dtype.kind == "f" for k in
                       ("theta_hat", "theta_sd", "b_hat", "a_hat"))
    # JAX's compare reads the port's cache
    argv = ["compare", "synthetic-2pl", *HMC, *VIBO_SMALL, "--methods",
            "hmc"]
    table = jcli.main([*argv, "--hmc-cache", caches["port"]])
    row = next(r for r in table if r["method"] == "hmc")
    assert row["cached"] is True
    assert -1.0 <= table[0]["theta_vs_hmc"] <= 1.0
    # the port's compare reads JAX's, on JAX's VIBO params
    fits = []
    want = _jax_run([*argv, "--hmc-cache", caches["jax"]], monkeypatch, fits)
    _port_fit_from(monkeypatch, fits[0])
    got = cli.main([*argv, "--hmc-cache", caches["jax"], "--cpu"])
    assert [r["method"] for r in got] == ["vibo", "hmc"]
    assert got[1]["cached"] is True and got[1]["b_vs_hmc"] == 1.0
    for key in ("theta_vs_hmc", "sigma_vs_hmc", "laplace_sigma_vs_hmc",
                "heldout_acc", "ece"):
        _agree(got[0][key], want[0][key], key)
    # the item agreements JAX drops on a cached row, computed directly
    assert "b_vs_hmc" not in want[0]
    with np.load(f"{caches['jax']}/baseline_hmc.npz") as z:
        b_ref, a_ref, t_ref = z["b_hat"], z["a_hat"], z["theta_hat"]
    params = fits[0]["params"]["item_post"]
    b_hat = np.asarray(params["b"]["mu"])
    a_hat = np.asarray(params["a"]["mu"])
    theta_hat = np.asarray(jeval.infer_posterior_means(
        _jmodel(fits[0]), fits[0]["params"],
        _jds(["compare", "synthetic-2pl", *HMC]))[0])
    assert got[0]["b_vs_hmc"] == round(jeval.correlation(
        b_hat.ravel(), b_ref.ravel())["pearson"], 4)
    w = jeval.procrustes_rotation(theta_hat, t_ref)
    assert got[0]["a_vs_hmc"] == round(jeval.correlation(
        (a_hat @ w).ravel(), a_ref.ravel())["pearson"], 4)
    # a cache hit writes nothing
    with np.load(f"{caches['jax']}/baseline_hmc.npz") as z:
        assert z["theta_hat"].tobytes() == t_ref.tobytes()


def _jds(argv):
    ns = argparse.Namespace(
        dataset=argv[1],
        num_persons=int(argv[argv.index("--num-persons") + 1]),
        num_items=int(argv[argv.index("--num-items") + 1]), ability_dim=1,
        num_categories=5, artificial_missing_perc=0.1, missing_rate=0.0,
        data_dir=None, seed=0, irt_model="2pl")
    return jcli._load(ns)[0]


def _jmodel(res):
    from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
    enc = res["params"]["encoder"]
    return JVIBO(JConfig(num_items=12, irt_model="2pl",
                         hidden_dim=int(np.shape(enc[0]["w"])[1])))


def test_cache_mismatches_raise(caches, tmp_path):
    args = argparse.Namespace(hmc_cache=caches["jax"], seed=0)
    with np.load(f"{caches['jax']}/baseline_hmc.npz") as z:
        files = {k: z[k] for k in z.files}
        first = {"dataset": str(files["dataset"]),
                 "shape": [int(x) for x in files["shape"]]}
    row = cli._cached_hmc_row(args, first)
    assert row["cached"] and {"_theta_hat", "_theta_sd", "_b_hat",
                              "_a_hat"} <= set(row)
    for bad_first, bad_seed in (({**first, "dataset": "other"}, 0),
                                ({**first, "shape": [61, 12]}, 0),
                                (first, 1)):
        with pytest.raises(SystemExit, match="posterior reuse"):
            cli._cached_hmc_row(argparse.Namespace(
                hmc_cache=caches["jax"], seed=bad_seed), bad_first)
    # a deep gold: only the decoder it was sampled under may reuse it
    rng = np.random.default_rng(0)
    link = jax.tree.map(lambda x: np.asarray(x, np.float32), {
        "w_theta": rng.standard_normal((1, 4)), "b1": np.zeros(4),
        "w_item": rng.standard_normal((3, 4)),
        "layer2": {"w": np.eye(4), "b": np.zeros(4)},
        "out": {"w": np.ones((4, 1)), "b": np.zeros(1)}})
    deep = tmp_path / "deep"
    deep.mkdir()
    np.savez(deep / "baseline_hmc.npz", **files,
             deep_fingerprint=np.asarray(jcli._params_fingerprint(link)))
    args = argparse.Namespace(hmc_cache=str(deep), seed=0)
    assert cli._cached_hmc_row(args, {**first, "_deep_link": link})["cached"]
    other = {**link, "b1": np.ones(4, np.float32)}
    for first_row in ({**first, "_deep_link": other}, first):
        with pytest.raises(SystemExit, match="DEEP gold"):
            cli._cached_hmc_row(args, first_row)


def test_params_fingerprint_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"w_theta": rng.standard_normal((2, 8)).astype(np.float32),
            "layer2": {"w": rng.standard_normal((8, 8)).astype(np.float32),
                       "b": np.zeros(8, np.float32)},
            "b1": rng.standard_normal(8).astype(np.float32),
            "out": {"w": rng.standard_normal((8, 1)).astype(np.float32),
                    "b": np.zeros(1, np.float32)},
            "w_item": rng.standard_normal((3, 8)).astype(np.float32)}
    want = jcli._params_fingerprint(jax.tree.map(jax.numpy.asarray, tree))
    assert cli._params_fingerprint(tree) == want
    assert cli._params_fingerprint(params_from_jax(tree, "cpu")) == want
    assert cli._params_fingerprint({**tree, "b1": tree["b1"] + 1}) != want


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """JAX's `train --out-dir` on a pisa-format CSV (string item ids, so
    the checkpoint embeds a vocabulary)."""
    from vibo_tpu.data import simulate_irt as jsim
    tmp = tmp_path_factory.mktemp("score")
    ids = [f"Q-{j:02d}" for j in range(14)]
    sim = jsim("2pl", 90, 14, seed=3, missing_rate=0.1)
    with open(tmp / "pisa.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("student_id", "item_id", "correct"))
        w.writerows((f"s{p:03d}", ids[j], int(sim.response[p, j]))
                    for p in range(90) for j in range(14)
                    if sim.mask[p, j] > 0)
    jcli.main(["train", "pisa", "--data-dir", str(tmp), "--epochs", "4",
               "--eval-every", "2", "--hidden-dim", "16", "--out-dir",
               str(tmp / "run"), "--cpu"])
    return tmp, ids


def test_score_from_jax_checkpoint_matches_jax(jax_checkpoint):
    tmp, ids = jax_checkpoint
    ckpt = str(tmp / "run" / "best.npz")
    rng = np.random.default_rng(7)
    resp = (rng.random((21, 14)) < 0.5).astype(np.float32)
    mask = (rng.random((21, 14)) < 0.8).astype(np.float32)
    np.savez(tmp / "new.npz", response=resp, mask=mask)
    with open(tmp / "new.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("student_id", "item_id", "correct"))
        w.writerows((f"n{p:02d}", ids[j], int(resp[p, j]))
                    for p in range(21) for j in range(14) if mask[p, j])
        w.writerow(("n00", "UNSEEN", 1))
    for inp in ("new.npz", "new.csv"):
        outs = {}
        for side, main, extra in (("jax", jcli.main, []),
                                  ("port", cli.main, ["--cpu"])):
            out = str(tmp / f"{side}-{inp}.npz")
            summary = main(["score", "--checkpoint", ckpt, "--input",
                            str(tmp / inp), "--output", out,
                            "--batch-size", "8", *extra])
            with np.load(out) as z:
                outs[side] = ({k: z[k] for k in z.files}, summary)
        (got, gs), (want, ws) = outs["port"], outs["jax"]
        assert gs["num_persons"] == ws["num_persons"] == 21
        assert gs["num_unknown_item_responses"] == \
            ws["num_unknown_item_responses"] == (inp == "new.csv")
        assert list(got["person_ids"]) == list(want["person_ids"])
        for key in ("theta_mu", "theta_sigma", "prob"):
            _close(got[key], want[key], 1e-5)
    # per-person refinement: finite, of the right shapes
    out = str(tmp / "refined.npz")
    cli.main(["score", "--checkpoint", ckpt, "--input", str(tmp / "new.npz"),
              "--output", out, "--refine-theta", "4", "--cpu"])
    with np.load(out) as z:
        assert z["refined_theta_mu"].shape == (21, 1)
        assert z["refined_theta_tril"].shape == (21, 1, 1)
        assert np.isfinite(z["refined_theta_sigma"]).all()


def test_profile_writes_a_trace(tmp_path):
    cli.main(["train", "synthetic-1pl", "--num-persons", "64",
              "--num-items", "16", "--epochs", "2", "--eval-every", "2",
              "--hidden-dim", "16", "--profile", str(tmp_path / "trace"),
              "--no-compilation-cache", "--cpu"])
    traces = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_timer_and_throughput_match_jax():
    from vibo_tpu.utils import prof as jprof
    from vibo_tpu_torch.utils import prof
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    boxes = []
    for timer, arr in ((jprof.device_timer, jax.numpy.asarray(x)),
                       (prof.device_timer, torch.from_numpy(x))):
        with timer({}, key="t") as box:
            np.testing.assert_array_equal(np.asarray(box["force"](arr)), x)
        boxes.append(box)
    for box in boxes:
        assert box["forced"] is True and box["t"] >= 0.0
    assert prof.throughput_report(1200, 0.5) == jprof.throughput_report(
        1200, 0.5)
    assert prof.throughput_report(7, 0.0) == jprof.throughput_report(7, 0.0)
    assert prof.peak_hbm_bytes("cpu") is None


@pytest.mark.parametrize("flags,k", [
    (["--theta-posterior", "chol", "--iwae-samples", "4",
      "--refine-theta", "3"], 2),
    (["--condition-on", "stats", "--theta-posterior", "laplace-w"], 2),
    (["--condition-on", "stats", "--theta-posterior", "laplace",
      "--irt-model", "3pl"], 2),
    (["--item-encoder", "--iwae-samples", "4"], 2),
    (["--item-encoder", "--theta-posterior", "chol", "--eval-new-items",
      "0.25"], 2),
])
def test_family_flags_match_jax(flags, k, monkeypatch):
    """Each family flag through both command lines on the CPU: JAX trains,
    the port scores JAX's params (every summary key and underscore array,
    _theta_scale_tril among them where the family has one)."""
    argv = ["train", "synthetic-2pl", *SMALL, "--ability-dim", str(k),
            *flags]
    fits = []
    want = _jax_run(argv, monkeypatch, fits)
    _port_fit_from(monkeypatch, fits[-1])
    _replay_eval(monkeypatch, 0, fits[0]["params"], k)
    got = cli.main([*argv, "--cpu"])
    _summaries_agree(got, want)
    split = "--eval-new-items" in flags     # no whole-matrix summaries
    assert ("_theta_scale_tril" in got) == ("--theta-posterior" in flags
                                            and not split)
    assert ("new_item_acc" in got) == split


def test_unported_flags_raise():
    with pytest.raises(SystemExit):
        cli.main(["train", "synthetic-2pl", "--num-persons", "40",
                  "--num-items", "8", "--epochs", "1", "--eval-new-items",
                  "0.2", "--cpu"])


@pytest.fixture(scope="module")
def item_checkpoints(tmp_path_factory):
    """An item-encoder run's best.npz written by each package's `train
    --out-dir`, and a matrix of new items' columns."""
    tmp = tmp_path_factory.mktemp("items")
    argv = ["train", "synthetic-2pl", "--num-persons", "80", "--num-items",
            "12", "--epochs", "4", "--eval-every", "2", "--hidden-dim", "16",
            "--ability-dim", "2", "--item-encoder"]
    jcli.main([*argv, "--out-dir", str(tmp / "jax"), "--cpu"])
    cli.main([*argv, "--out-dir", str(tmp / "port"), "--cpu"])
    rng = np.random.default_rng(5)
    resp = (rng.random((37, 5)) < 0.6).astype(np.float32)
    mask = (rng.random((37, 5)) < 0.85).astype(np.float32)
    np.savez(tmp / "new_items.npz", response=resp, mask=mask)
    return tmp


@pytest.mark.parametrize("side", ["jax", "port"])
def test_score_items_matches_jax(item_checkpoints, side):
    """`score --items` from each package's checkpoint: the port's output
    against JAX's own command (a JAX checkpoint) or JAX's item encoder on
    the port's params (a port checkpoint, which JAX cannot load)."""
    from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
    from vibo_tpu_torch.convert import params_to_numpy
    from vibo_tpu_torch.serve import AbilityScorer
    tmp = item_checkpoints
    ckpt = str(tmp / side / "best.npz")
    inp = str(tmp / "new_items.npz")
    out = str(tmp / f"{side}_port_items.npz")
    summary = cli.main(["score", "--checkpoint", ckpt, "--input", inp,
                        "--items", "--output", out, "--cpu"])
    assert summary["mode"] == "items" and summary["num_new_items"] == 5
    with np.load(out) as z:
        got = {k: z[k] for k in z.files}
    if side == "jax":
        jout = str(tmp / "jax_jax_items.npz")
        want = jcli.main(["score", "--checkpoint", ckpt, "--input", inp,
                          "--items", "--output", jout])
        assert want["params"] == summary["params"]
        with np.load(jout) as z:
            want = {k: z[k] for k in z.files}
    else:
        scorer = AbilityScorer.from_checkpoint(ckpt, device="cpu")
        cfg = scorer.model.cfg
        jm = JVIBO(JConfig(**{f: getattr(cfg, f) for f in (
            "num_items", "irt_model", "ability_dim", "hidden_dim",
            "item_encoder", "item_encoder_hidden")}))
        with np.load(inp) as z:
            post = jm.item_dist(params_to_numpy(scorer.params),
                                jax.numpy.asarray(z["response"]),
                                jax.numpy.asarray(z["mask"]), new_items=True)
        want = {}
        for name, p in post.items():
            want[f"{name}_mu"] = np.asarray(p["mu"])
            want[f"{name}_sigma"] = np.exp(0.5 * np.asarray(p["logvar"]))
    assert sorted(got) == sorted(want) == ["a_mu", "a_sigma", "b_mu",
                                           "b_sigma"]
    for key in want:
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6)


def test_score_items_and_the_card_raise(jax_checkpoint):
    tmp, _ = jax_checkpoint
    # the free-form item posterior has no parameters for unseen items
    np.savez(tmp / "cols.npz", response=np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="item_encoder"):
        cli.main(["score", "--checkpoint", str(tmp / "run" / "best.npz"),
                  "--input", str(tmp / "cols.npz"), "--items", "--cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["train", "synthetic-2pl", "--num-persons", "40",
                      "--num-items", "8", "--epochs", "1"])
