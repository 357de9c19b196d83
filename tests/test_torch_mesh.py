"""The port's mesh (vibo_tpu_torch.parallel, Trainer(mesh=), the sharded
evaluators) on gloo CPU ranks, held against the port on one device.

One spawn of four ranks (tests/torch_mesh_ranks.py, which imports no JAX)
runs every job below; each test reads its part. Meshes over subsets of the
four ranks give 1, 2 and 4 ranks in one world: 1 x 1, 2 x 1, 4 x 1, 2 x 2,
1 x 2 and 1 x 4 (students x items). Small shapes (48 x 40, K = 2, hidden
16), f32:
- make_mesh's shapes, coordinates and groups, and its error on an item axis
  that does not divide the world;
- the packed steps (students only, 2D) of every link and both objectives,
  and the decoded steps, against the one-device step on the same noise:
  two SGD steps (an update linear in the gradient, so a factor of the
  shard count would show), the second step's gradient, the params and the
  aux within 1e-5 (the ELBO) or 1e-4 (the IWAE bound, whose sample weights
  move by ~1e-5 with the f32 rounding of log-weights that are sums of
  ~1,000 over the batch) of each array's largest element, and the same on
  every mesh (the device count changes nothing but the summation order);
  the families' 2D forms (chol, laplace, laplace-w, stats, mean, the item
  encoder) likewise;
- fit on a mesh against fit on one device: students that do not divide
  (padding rows inert, zero noise), items that do not divide (packed=True
  raises, auto falls back to the decoded full batch), the decoded full
  batch, minibatches, restarts, resume, warm start, and out_dir written
  once;
- the sharded evaluators against the one-device ones (rtol 1e-6; ECE
  1e-4) on every mesh.
Every rank of a mesh holds bitwise the same params after its steps."""

import numpy as np
import pytest
import torch

from vibo_tpu_torch import evaluation
from vibo_tpu_torch.convert import params_from_jax, params_to_numpy, tree_leaves
from vibo_tpu_torch.data import holdout_split
from vibo_tpu_torch.data.masking import Dataset
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops.packing import pack_responses
from vibo_tpu_torch.train import Trainer, TrainConfig, save_checkpoint
from vibo_tpu_torch.train import checkpoint as ckpt

from torch_mesh_ranks import run_world

N, M, K, H, S = 48, 40, 2, 16, 2
C = 4                                      # grm/gpcm categories
WORLD = 4
MESHES = {"1x1": ((0,), 1), "2x1": ((0, 1), 1), "4x1": ((0, 1, 2, 3), 1),
          "2x2": ((0, 1, 2, 3), 2), "1x2": ((0, 1), 2),
          "1x4": ((0, 1, 2, 3), 4)}
LINKS = ("2pl", "3pl", "grm", "gpcm", "deep")
FAMILIES = {"chol": dict(theta_posterior="chol"),
            "laplace": dict(theta_posterior="laplace", condition_on="stats"),
            "laplace_w": dict(theta_posterior="laplace-w"),
            "stats": dict(condition_on="stats"),
            "stats_chol_3pl": dict(condition_on="stats",
                                   theta_posterior="chol", irt_model="3pl"),
            "mean": dict(condition_on="mean"),
            "item_encoder": dict(item_encoder=True),
            "item_encoder_iwae": dict(item_encoder=True)}
FIT_KW = dict(lr=1e-2, epochs=4, eval_every=2, log_every=1)
LR = 2.0 ** -6                             # the steps' SGD rate
TOL = {"elbo": 1e-5, "iwae": 1e-4}         # module doc


def _config(irt_model="2pl", **kw) -> dict:
    return dict(num_items=kw.pop("num_items", M), irt_model=irt_model,
                ability_dim=K, hidden_dim=H, compute_dtype="float32",
                num_categories=C if irt_model in ("grm", "gpcm") else 2,
                item_latent_dim=4, deep_hidden_dim=16,
                use_pallas=kw.pop("use_pallas", True), **kw)


def _data(rng, irt_model="2pl", n=N, m=M):
    resp = (rng.integers(0, C, (n, m)) if irt_model in ("grm", "gpcm")
            else rng.random((n, m)) < 0.5).astype(np.float32)
    mask = (rng.random((n, m)) < 0.85).astype(np.float32)
    mask[5] = 0.0                          # a person with no observed cell
    return resp * mask, mask


def _noise(model, rng, n, transposed, samples=S):
    """Numpy noise as sample_noise gives it, theta drawn (S, n, K) and
    transposed to (S, K, n) for the transposed layout: every mesh of a
    seed gives each person the same draw."""
    item, theta = model.sample_noise(n, samples,
                                     generator=torch.Generator().manual_seed(
                                         int(rng.integers(1 << 30))))
    theta = theta.numpy()
    return ({k: v.numpy() for k, v in item.items()},
            np.ascontiguousarray(theta.transpose(0, 2, 1)) if transposed
            else theta)


def _step_case(name, mesh, irt_model="2pl", objective="elbo",
               decoded=False, seed=0, **family):
    """A step job and what the one-device reference needs."""
    rng = np.random.default_rng(seed)
    cfg = _config(irt_model, **family)
    model = VIBO(VIBOConfig(**cfg), device="cpu")
    resp, mask = _data(rng, irt_model)
    ranks, axis = MESHES[mesh]
    tp = (not decoded and axis == 1 and model.wants_transposed_theta())
    noise = [_noise(model, rng, N, tp) for _ in range(2)]
    job = {"kind": "step", "name": name, "ranks": ranks, "item_axis": axis,
           "config": cfg, "train": {"objective": objective,
                                    "max_grad_norm": None,
                                    "num_mc_samples": S},
           "params": params_to_numpy(model.init_params(seed)),
           "rows": N, "noise": noise, "item_scale": 0.8, "lr": LR,
           "tp": tp}
    if decoded:
        job["decoded"] = (resp, mask)
    else:
        job["packed"] = pack_responses(resp, mask)
        job["row_valid"] = (mask.sum(-1) > 0).astype(np.float32)
    return job


def _reference_step(job):
    """The job's steps on one device: (params after, the last step's
    gradients, aux list)."""
    model = VIBO(VIBOConfig(**job["config"]), device="cpu")
    trainer = Trainer(model, TrainConfig(**job["train"]), device="cpu")
    params = params_from_jax(job["params"], "cpu")
    opt = torch.optim.SGD(tree_leaves(params), lr=job["lr"])
    auxs = []
    for item, theta in job["noise"]:
        noise = ({k: torch.from_numpy(v) for k, v in item.items()},
                 torch.from_numpy(theta))
        if "decoded" in job:
            resp, mask = (torch.from_numpy(x) for x in job["decoded"])
            aux = trainer.minibatch_step_with_noise(
                params, opt, resp, mask, *noise, job["item_scale"])
        else:
            aux = trainer.step_with_noise(
                params, opt, torch.from_numpy(job["packed"]),
                torch.from_numpy(job["row_valid"]), *noise,
                job["item_scale"], transposed=job["tp"])
        auxs.append({k: float(v) for k, v in aux.items()})
    return (params_to_numpy(params),
            [p.grad.numpy() for p in tree_leaves(params)], auxs)


def _ds(seed=0, irt_model="2pl", n=N, m=M):
    rng = np.random.default_rng(seed)
    ds = holdout_split(*_data(rng, irt_model, n, m), 0.2, seed=seed,
                       num_categories=C if irt_model in ("grm", "gpcm")
                       else 2)
    return ds


def _fit_job(name, mesh, ds, cfg, train, **extra):
    ranks, axis = MESHES[mesh]
    return {"kind": "fit", "name": name, "ranks": ranks, "item_axis": axis,
            "config": cfg, "train": train,
            "ds": (ds.response, ds.train_mask, ds.heldout_mask),
            "categories": ds.num_categories, **extra}


def _jobs(tmp):
    jobs = [{"kind": "shapes", "name": "shapes", "axes": (1, 2, 4, 3)}]
    for mesh in MESHES:
        for objective in ("elbo", "iwae"):
            jobs.append(_step_case(f"invariance/{objective}/{mesh}", mesh,
                                   objective=objective, seed=1))
    for link in LINKS:
        for objective in ("elbo", "iwae"):
            for mesh in ("4x1", "2x2"):
                jobs.append(_step_case(f"link/{link}/{objective}/{mesh}",
                                       mesh, link, objective, seed=2))
    for fam, kw in FAMILIES.items():
        objective = "iwae" if fam.endswith("_iwae") else "elbo"
        for mesh in ("2x2", "4x1"):
            jobs.append(_step_case(f"family/{fam}/{mesh}", mesh,
                                   objective=objective, seed=3, **kw))
    for objective in ("elbo", "iwae"):
        for mesh in ("2x1", "2x2"):
            jobs.append(_step_case(f"decoded/{objective}/{mesh}", mesh,
                                   objective=objective, decoded=True,
                                   seed=4, item_encoder=True))
    # fit: 45 students on 4 shards, 41 items on 2 item shards
    ds45 = _ds(5, n=45)
    jobs.append(_fit_job("fit/students45", "4x1", ds45, _config(),
                         FIT_KW))
    ds41 = _ds(6, m=41)
    cfg41 = _config(num_items=41)
    jobs.append(_fit_job("fit/items41/packed", "2x2", ds41, cfg41,
                         {**FIT_KW, "packed": True}))
    jobs.append(_fit_job("fit/items41/auto", "2x2", ds41, cfg41, FIT_KW))
    ds = _ds(7)
    # the 2D tile draws theta eps (S, B, K), as the one-device step does
    # for the full-covariance family
    jobs.append(_fit_job("fit/2d", "2x2", ds,
                         _config(theta_posterior="chol"), FIT_KW))
    jobs.append(_fit_job("fit/decoded", "2x1", ds, _config(),
                         {**FIT_KW, "packed": False}))
    jobs.append(_fit_job("fit/minibatch", "2x1", ds, _config(),
                         {**FIT_KW, "batch_size": 20}))
    jobs.append(_fit_job("fit/restarts", "2x1", ds, _config(),
                         {**FIT_KW, "restarts": 2}))
    jobs.append(_fit_job("fit/out_dir", "2x1", ds, _config(),
                         {**FIT_KW, "out_dir": str(tmp / "out")}))
    jobs.append(_fit_job("fit/resume", "4x1", ds, _config(), FIT_KW,
                         resume=str(tmp / "mid.npz")))
    jobs.append(_fit_job("fit/warm_start", "2x1", ds, _config(),
                         {**FIT_KW, "warm_start": str(tmp / "mid.npz")}))
    for fam in ("2pl", "grm", "item_encoder"):
        irt = "grm" if fam == "grm" else "2pl"
        cfg = _config(irt, item_encoder=fam == "item_encoder")
        eds = _ds(8, irt)
        model = VIBO(VIBOConfig(**cfg), device="cpu")
        for mesh in ("1x1", "4x1", "2x2"):
            ranks, axis = MESHES[mesh]
            jobs.append({"kind": "eval", "name": f"eval/{fam}/{mesh}",
                         "ranks": ranks, "item_axis": axis, "config": cfg,
                         "params": params_to_numpy(model.init_params(3)),
                         "ds": (eds.response, eds.train_mask,
                                eds.heldout_mask),
                         "categories": eds.num_categories, "samples": 6,
                         "seed": 9})
    return jobs


def _mid_checkpoint(path):
    """A 2-epoch single-device fit of _ds(7)'s model, saved: the resume and
    warm-start jobs start from it."""
    model = VIBO(VIBOConfig(**_config()), device="cpu")
    tr = Trainer(model, TrainConfig(**{**FIT_KW, "epochs": 2}), device="cpu")
    res = tr.fit(_ds(7))
    save_checkpoint(str(path), ckpt.train_state(res["params"],
                                                res["optimizer"]),
                    res["generator"], 2,
                    extra={"model_cfg": tr._cfg_json()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    _mid_checkpoint(tmp / "mid.npz")
    jobs = _jobs(tmp)
    results = run_world(WORLD, jobs)
    by_name = {}
    for i, job in enumerate(jobs):
        by_name[job["name"]] = (job, [r[i] for r in results])
    return by_name, tmp


def _rank0(world, name):
    """(job, its mesh's first rank's result, every mesh rank's)."""
    job, per_rank = world[0][name]
    ranks = job.get("ranks", tuple(range(WORLD)))
    return job, per_rank[ranks[0]], [per_rank[r] for r in ranks]


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


def _same_everywhere(results):
    assert len({r["digest"] for r in results}) == 1


def _check_step(world, name, ref):
    """The mesh run's params, last gradients and aux against the one-device
    reference; every rank the same params."""
    job, res, results = _rank0(world, name)
    tol = TOL[job["train"]["objective"]]
    _same_everywhere(results)
    ref_params, ref_grads, ref_aux = ref
    for a, b in zip(tree_leaves(res["params"]), tree_leaves(ref_params)):
        _close(a, b, tol, name)
    for a, b in zip(res["grads"], ref_grads):
        _close(a, b, tol, (name, "grad"))
    for a, b in zip(res["aux"], ref_aux):
        for k in a:
            _close(a[k], b[k], tol, (name, k))


def test_make_mesh_shapes(world):
    results = [world[0]["shapes"][1][r] for r in range(WORLD)]
    for r, res in enumerate(results):
        assert res[1]["shape"] == {"students": 4, "items": 1}
        assert res[2]["shape"] == {"students": 2, "items": 2}
        assert res[4]["shape"] == {"students": 1, "items": 4}
        assert (res[2]["student_index"], res[2]["item_index"]) == divmod(r, 2)
        assert res[2]["sizes"] == (2, 2, 4) and res[1]["sizes"] == (4, 1, 4)
        assert res[4]["sizes"] == (1, 4, 4)
        assert res[3] == "4 devices not divisible by item_axis=3"


def test_make_mesh_default_device_is_the_card(world):
    """Over gloo, make_mesh with no device takes cuda:LOCAL_RANK, as every
    entry point takes the card: here, with no card, it raises."""
    for r in range(WORLD):
        got = world[0]["shapes"][1][r]["default_device"]
        if torch.cuda.is_available():
            assert got.startswith("cuda:")
        else:
            assert "CUDA is not available" in got


@pytest.mark.parametrize("objective", ["elbo", "iwae"])
def test_steps_device_count_invariant(world, objective):
    """The students-only and 2D steps on 1, 2 and 4 ranks (1 x 1, 2 x 1,
    4 x 1, 2 x 2, 1 x 2, 1 x 4) against one device and each other."""
    ref = _reference_step(world[0][f"invariance/{objective}/1x1"][0])
    got = {}
    for mesh in MESHES:
        name = f"invariance/{objective}/{mesh}"
        # the layout of the noise differs between students-only and 2D
        _check_step(world, name, _reference_step(world[0][name][0]))
        got[mesh] = _rank0(world, name)[1]
    for mesh in MESHES:
        for a, b in zip(tree_leaves(got[mesh]["params"]),
                        tree_leaves(ref[0])):
            _close(a, b, 1e-6, mesh)


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("objective", ["elbo", "iwae"])
def test_link_steps_match_one_device(world, link, objective):
    for mesh in ("4x1", "2x2"):
        name = f"link/{link}/{objective}/{mesh}"
        _check_step(world, name, _reference_step(world[0][name][0]))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_2d_steps_match_one_device(world, family):
    for mesh in ("2x2", "4x1"):
        name = f"family/{family}/{mesh}"
        _check_step(world, name, _reference_step(world[0][name][0]))


@pytest.mark.parametrize("objective", ["elbo", "iwae"])
def test_decoded_steps_match_one_device(world, objective):
    """The decoded step (minibatches, the decoded full batch) on a mesh:
    each rank its rows, the item axis replicated (2 x 2: two copies)."""
    for mesh in ("2x1", "2x2"):
        name = f"decoded/{objective}/{mesh}"
        _check_step(world, name, _reference_step(world[0][name][0]))


def _fit_one_device(job, **kw):
    model = VIBO(VIBOConfig(**job["config"]), device="cpu")
    ds = Dataset(*job["ds"], num_categories=job["categories"])
    train = {**job["train"], **kw}
    return Trainer(model, TrainConfig(**train), device="cpu").fit(
        ds, resume=job.get("resume"))


def _check_fit(res, ref, tol=1e-5):
    hist = [{k: v for k, v in h.items() if k != "cells_per_sec"}
            for h in ref["history"]]
    assert [h["event"] for h in res["history"]] == [h["event"] for h in hist]
    for a, b in zip(res["history"], hist):
        for k in ("elbo", "loglik", "kl_theta", "kl_items", "acc"):
            if k in b:
                _close(a[k], b[k], tol, k)
    _close(res["final_elbo"], ref["final_elbo"], tol)
    for a, b in zip(tree_leaves(res["params"]), tree_leaves(ref["params"])):
        _close(a, b.detach(), tol)


def test_fit_students_not_dividing(world):
    """45 students on 4 shards: three zero padding rows, row weight 0, zero
    noise; the fit equals the one-device fit."""
    job, res, results = _rank0(world, "fit/students45")
    _same_everywhere(results)
    _check_fit(res, _fit_one_device(job))


def test_fit_items_not_dividing(world):
    """41 items on 2 item shards: packed=True raises JAX's error; auto takes
    the decoded full batch (the item axis replicated), as JAX does."""
    _, res, results = _rank0(world, "fit/items41/packed")
    assert all("needs num_items divisible by the items axis" in r["error"]
               for r in results)
    job, res, results = _rank0(world, "fit/items41/auto")
    _same_everywhere(results)
    _check_fit(res, _fit_one_device(job, packed=False))


@pytest.mark.parametrize("name", ["fit/2d", "fit/decoded", "fit/minibatch",
                                  "fit/restarts", "fit/resume",
                                  "fit/warm_start"])
def test_fit_paths_match_one_device(world, name):
    job, res, results = _rank0(world, name)
    _same_everywhere(results)
    _check_fit(res, _fit_one_device(job))


def test_fit_out_dir_written_once(world):
    job, res, results = _rank0(world, "fit/out_dir")
    assert set(res["out_dir"]) == {"best.npz", "metrics.jsonl"}
    lines = (world[1] / "out" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len(res["history"])
    extra = ckpt.peek_extra(str(world[1] / "out" / "best.npz"))
    assert float(extra["heldout_acc"]) == res["best"]["heldout_acc"]
    assert int(extra["epoch"]) == res["best"]["epoch"]


@pytest.mark.parametrize("fam", ["2pl", "grm", "item_encoder"])
def test_sharded_evaluators_match_one_device(world, fam):
    """Imputation accuracy, calibration (rtol 1e-6; ECE 1e-4) and the IWAE
    bound (the same generator: the same noise) on 1, 4 and 2 x 2 ranks
    against the one-device evaluators."""
    job = world[0][f"eval/{fam}/1x1"][0]
    model = VIBO(VIBOConfig(**job["config"]), device="cpu")
    params = params_from_jax(job["params"], "cpu")
    ds = Dataset(*job["ds"], num_categories=job["categories"])
    imp = evaluation.imputation_accuracy(model, params, ds)
    cal = evaluation.calibration(model, params, ds)
    gen = torch.Generator().manual_seed(job["seed"])
    iw = {on: evaluation.iwae_loglik(model, params, ds, job["samples"],
                                     on=on, generator=gen)
          for on in ("heldout", "train")}
    for mesh in ("1x1", "4x1", "2x2"):
        _, res, results = _rank0(world, f"eval/{fam}/{mesh}")
        for r in results:
            assert r["impute"]["num_heldout"] == imp["num_heldout"] > 0
            np.testing.assert_allclose(r["impute"]["acc"], imp["acc"],
                                       rtol=1e-6)
            np.testing.assert_allclose(r["impute"]["base_rate"],
                                       imp["base_rate"], rtol=1e-6)
            np.testing.assert_allclose(r["calibration"]["ece"], cal["ece"],
                                       rtol=1e-4, atol=1e-7)
            np.testing.assert_allclose(r["calibration"]["brier"],
                                       cal["brier"], rtol=1e-6)
            assert r["calibration"]["bin_count"] == cal["bin_count"]
            for on in ("heldout", "train"):
                assert r[f"iwae_{on}"]["num_cells"] == iw[on]["num_cells"]
                np.testing.assert_allclose(r[f"iwae_{on}"]["loglik"],
                                           iw[on]["loglik"], rtol=1e-6)
