"""The port's mesh steps and sharded evaluators against JAX's, on the same
inputs: JAX's shard_map steps (`Trainer.make_step_packed_dp`: students
only on a 4 x 1 mesh, 2D on a 2 x 2 mesh of the eight_devices fixture) and
`evaluation.*_sharded`, the port on four gloo CPU ranks
(tests/torch_mesh_ranks.py) in the same layouts, JAX's params and its own
noise (`VIBO.sample_noise` on the step's key) fed to both.

Each step is one SGD step (JAX's optimizer swapped for optax.sgd, the
port's for torch.optim.SGD, clip off, as JAX's own grad-equality tests
do), so the update is linear in the gradient; the params after it and the
reported bound agree within 1e-4 of each array's largest element at f32,
for every link and both objectives (use_pallas off on both sides: JAX's
dense route, which its interpret-mode kernels would only slow here; the
port's kernels' plain versions are held against the one-device step in
test_torch_mesh.py), and for the families' 2D forms (chol, laplace,
laplace-w, stats, the item encoder). The evaluators: accuracy and base
rate at rtol 1e-6, ECE 1e-4, Brier and the IWAE bounds 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from vibo_tpu import evaluation as jevaluation
from vibo_tpu.data.masking import holdout_split as jholdout
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu.parallel import make_mesh as jmake_mesh
from vibo_tpu.train.trainer import Trainer as JTrainer, TrainConfig as JTC

from torch_mesh_ranks import run_world

N, M, K, H, S = 48, 40, 2, 16, 2
C = 4
LR, ITEM_SCALE = 2.0 ** -6, 0.8
LINKS = ("2pl", "3pl", "grm", "gpcm", "deep")
FAMILIES = {"chol": dict(theta_posterior="chol"),
            "laplace": dict(theta_posterior="laplace", condition_on="stats"),
            "laplace_w": dict(theta_posterior="laplace-w"),
            "stats": dict(condition_on="stats"),
            "item_encoder": dict(item_encoder=True)}
MESHES = {"4x1": 1, "2x2": 2}
TOL = 1e-4


def _config(irt_model="2pl", **kw) -> dict:
    return dict(num_items=M, irt_model=irt_model, ability_dim=K,
                hidden_dim=H, compute_dtype="float32",
                num_categories=C if irt_model in ("grm", "gpcm") else 2,
                item_latent_dim=4, deep_hidden_dim=16, **kw)


def _data(rng, irt_model):
    resp = (rng.integers(0, C, (N, M)) if irt_model in ("grm", "gpcm")
            else rng.random((N, M)) < 0.5).astype(np.float32)
    mask = (rng.random((N, M)) < 0.85).astype(np.float32)
    mask[5] = 0.0
    return resp * mask, mask


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_step(name, devices, mesh, cfg, objective, seed):
    """JAX's mesh step on the case's data and the port's job for it."""
    rng = np.random.default_rng(seed)
    resp, mask = _data(rng, cfg["irt_model"])
    packed = jpack(resp, mask)
    rowv = (mask.sum(-1) > 0).astype(np.float32)
    jmodel = JVIBO(JConfig(**cfg))
    axis = MESHES[mesh]
    jmesh = jmake_mesh(devices[:4], item_axis=axis)
    tr = JTrainer(jmodel, JTC(objective=objective), mesh=jmesh)
    tr.optimizer = optax.sgd(LR)
    p0 = jmodel.init_params(jax.random.key(seed))
    p0_np = _numpy(p0)                     # the step donates p0
    key = jax.random.key(seed + 100)
    tp = axis == 1 and jmodel.wants_transposed_theta()
    item_eps, theta_eps = jmodel.sample_noise(p0, key, N, S, transposed=tp)
    step = tr.make_step_packed_dp(ITEM_SCALE, S)
    sh_pk, sh_rv = tr._dp_in_shardings()
    p1, _, aux = step(p0, tr.optimizer.init(p0),
                      key, jax.device_put(jnp.asarray(packed), sh_pk),
                      jax.device_put(jnp.asarray(rowv), sh_rv))
    job = {"kind": "step", "name": name, "ranks": (0, 1, 2, 3),
           "item_axis": axis, "config": cfg,
           "train": {"objective": objective, "max_grad_norm": None,
                     "num_mc_samples": S},
           "params": p0_np, "rows": N,
           "noise": [(_numpy(item_eps), np.asarray(theta_eps))],
           "item_scale": ITEM_SCALE, "lr": LR, "packed": packed,
           "row_valid": rowv}
    return job, {"params": _numpy(p1), "elbo": float(aux["elbo"]),
                 "loglik": float(aux["loglik"]),
                 "kl_theta": float(aux["kl_theta"]),
                 "kl_items": float(aux["kl_items"])}


def _eval_case(name, devices, mesh, irt_model, seed=8):
    rng = np.random.default_rng(seed)
    cats = C if irt_model in ("grm", "gpcm") else 2
    ds = jholdout(*_data(rng, irt_model), 0.2, seed=seed,
                  num_categories=cats)
    cfg = _config(irt_model)
    jmodel = JVIBO(JConfig(**cfg))
    params = jmodel.init_params(jax.random.key(seed))
    jmesh = jmake_mesh(devices[:4], item_axis=MESHES[mesh])
    key = jax.random.key(seed + 1)
    want = {"impute": jevaluation.imputation_accuracy_sharded(
                jmodel, params, ds, jmesh),
            "calibration": jevaluation.calibration_sharded(
                jmodel, params, ds, jmesh)}
    for on in ("heldout", "train"):
        want[f"iwae_{on}"] = jevaluation.iwae_loglik_sharded(
            jmodel, params, key, ds, jmesh, num_samples=6, on=on)
    item_eps, theta_eps = jmodel.sample_noise(params, key, N, 6)
    job = {"kind": "eval", "name": name, "ranks": (0, 1, 2, 3),
           "item_axis": MESHES[mesh], "config": cfg,
           "params": _numpy(params),
           "ds": (ds.response, ds.train_mask, ds.heldout_mask),
           "categories": cats, "samples": 6,
           "noise": (_numpy(item_eps), np.asarray(theta_eps))}
    return job, want


@pytest.fixture(scope="module")
def runs(eight_devices):
    jobs, want = [], {}
    for link in LINKS:
        for objective in ("elbo", "iwae"):
            for mesh in MESHES:
                name = f"link/{link}/{objective}/{mesh}"
                job, want[name] = _jax_step(name, eight_devices, mesh,
                                            _config(link), objective, 2)
                jobs.append(job)
    for fam, kw in FAMILIES.items():
        name = f"family/{fam}/2x2"
        job, want[name] = _jax_step(name, eight_devices, "2x2",
                                    _config(**kw), "elbo", 3)
        jobs.append(job)
    for link in ("2pl", "grm"):
        for mesh in MESHES:
            name = f"eval/{link}/{mesh}"
            job, want[name] = _eval_case(name, eight_devices, mesh, link)
            jobs.append(job)
    results = run_world(4, jobs)
    return {job["name"]: ([r[i] for r in results], want[job["name"]])
            for i, job in enumerate(jobs)}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, (what, err)


def _check(runs, name):
    results, want = runs[name]
    assert len({r["digest"] for r in results}) == 1
    got = results[0]
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        _close(a, b, TOL, name)
    for k in ("elbo", "loglik", "kl_theta", "kl_items"):
        _close(got["aux"][0][k], want[k], TOL, (name, k))


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("objective", ["elbo", "iwae"])
def test_mesh_steps_match_jax(runs, link, objective):
    for mesh in MESHES:
        _check(runs, f"link/{link}/{objective}/{mesh}")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_2d_family_steps_match_jax(runs, family):
    _check(runs, f"family/{family}/2x2")


@pytest.mark.parametrize("link", ["2pl", "grm"])
def test_sharded_evaluators_match_jax(runs, link):
    for mesh in MESHES:
        results, want = runs[f"eval/{link}/{mesh}"]
        for got in results:
            imp, wimp = got["impute"], want["impute"]
            assert imp["num_heldout"] == wimp["num_heldout"] > 0
            np.testing.assert_allclose(imp["acc"], wimp["acc"], rtol=1e-6)
            np.testing.assert_allclose(imp["base_rate"], wimp["base_rate"],
                                       rtol=1e-6)
            cal, wcal = got["calibration"], want["calibration"]
            np.testing.assert_allclose(cal["ece"], wcal["ece"], rtol=1e-4,
                                       atol=1e-7)
            np.testing.assert_allclose(cal["brier"], wcal["brier"],
                                       rtol=1e-5)
            assert cal["bin_count"] == wcal["bin_count"]
            for on in ("heldout", "train"):
                g, w = got[f"iwae_{on}"], want[f"iwae_{on}"]
                assert g["num_cells"] == w["num_cells"]
                np.testing.assert_allclose(g["loglik"], w["loglik"],
                                           rtol=1e-5)
