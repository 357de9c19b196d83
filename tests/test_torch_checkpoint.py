"""The port's checkpoints and the rest of `fit` (counterparts of
tests/test_checkpoint.py), on the CPU:

- the round trip, bitwise (params, Adam's state, the generator state, the
  step and extra), and a structure mismatch refused;
- 4 steps equal 2 steps, save, load and 2 more, bitwise, on eager steps
  and through make_scan; fit(resume=) equal to one uninterrupted fit with
  fuse_epochs on and off;
- warm_start: mean-field -> conditional preserves the function, scrambled
  transplants are refused (K, hidden, conditional -> mean-field), and
  warm_start with resume is refused;
- restarts=2 keeps the best final ELBO and promotes its best.npz;
- metrics.jsonl carries JAX's record keys;
- truth's theta_pearson and infer_posterior_means against JAX on the same
  params at 1e-5;
- AbilityScorer.from_checkpoint on a JAX Trainer checkpoint (written by
  JAX's fit(out_dir=...)) and on a port checkpoint scores as JAX's
  from_checkpoint does, at 1e-5.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from vibo_tpu import evaluation as jeval
from vibo_tpu.data import holdout_split as jholdout, simulate_irt as jsim
from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
from vibo_tpu.serve import AbilityScorer as JScorer
from vibo_tpu.train import Trainer as JTrainer, TrainConfig as JTrainConfig
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.convert import params_from_jax, tree_leaves
from vibo_tpu_torch.models import VIBO, VIBOConfig
from vibo_tpu_torch.ops.packing import packed_on_device
from vibo_tpu_torch.serve import AbilityScorer
from vibo_tpu_torch.train import Trainer, TrainConfig
from vibo_tpu_torch.train import checkpoint as ckpt

M = 16


def _data(n: int = 64, m: int = M, k: int = 1, seed: int = 0,
          model: str = "2pl"):
    kw = {"num_categories": 4} if model == "grm" else {}
    sim = jsim(model, n, m, ability_dim=k, seed=seed, **kw)
    return sim, jholdout(sim.response, sim.mask, 0.1, seed=seed, **kw)


def _model(hidden: int = 16, **kw):
    return VIBO(VIBOConfig(num_items=kw.pop("num_items", M),
                           hidden_dim=hidden, **kw), device="cpu")


def _equal_trees(x, y) -> bool:
    lx, ly = tree_leaves(x), tree_leaves(y)
    return len(lx) == len(ly) and all(torch.equal(a.detach(), b.detach())
                                      for a, b in zip(lx, ly))


def _steps(trainer, params, optimizer, packed, row_valid, gen, n, scan):
    if scan:
        trainer.make_scan(1.0, 1, n)(params, optimizer, packed, row_valid,
                                     gen)
    else:
        for _ in range(n):
            trainer.step(params, optimizer, packed, row_valid, gen)


def _fresh(trainer, seed):
    from vibo_tpu_torch.train.trainer import make_optimizer
    params = trainer.model.init_params(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    return params, make_optimizer(params, trainer.cfg.lr), gen


def test_roundtrip_exact(tmp_path):
    _, ds = _data()
    model = _model(use_pallas=True)
    tr = Trainer(model, TrainConfig(), device="cpu")
    packed, row_valid = packed_on_device(ds.response, ds.train_mask, "cpu")
    params, opt, gen = _fresh(tr, 0)
    tr.step(params, opt, packed, row_valid, gen)
    path = str(tmp_path / "ckpt.npz")
    ckpt.save_checkpoint(path, ckpt.train_state(params, opt), gen, step=7,
                         extra={"epoch": 3})
    p2, o2, _ = _fresh(tr, 1)
    template = ckpt.train_state(p2, o2)
    state, gen_state, step, extra = ckpt.load_checkpoint(path, template)
    assert _equal_trees(state, ckpt.train_state(params, opt))
    assert step == 7 and int(extra["epoch"]) == 3
    assert torch.equal(gen_state, gen.get_state())
    # the restored generator draws what the saved one draws next
    g2 = torch.Generator()
    g2.set_state(gen_state)
    assert torch.equal(torch.randn(5, generator=g2), torch.randn(5,
                                                                 generator=gen))
    assert all(t.requires_grad for t in tree_leaves(state[0]))


def test_structure_mismatch_raises(tmp_path):
    tr = Trainer(_model(), TrainConfig(), device="cpu")
    params, opt, gen = _fresh(tr, 0)
    path = str(tmp_path / "ckpt.npz")
    ckpt.save_checkpoint(path, ckpt.train_state(params, opt), gen, 0)
    other = Trainer(_model(hidden=32), TrainConfig(), device="cpu")
    p2, o2, _ = _fresh(other, 0)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_checkpoint(path, ckpt.train_state(p2, o2))


@pytest.mark.parametrize("scan", [False, True])
def test_resume_is_exact(tmp_path, scan):
    """4 steps == 2 steps, save, load into a fresh state, 2 more: params,
    Adam's state and the generator bitwise."""
    _, ds = _data()
    tr = Trainer(_model(use_pallas=True), TrainConfig(), device="cpu")
    packed, row_valid = packed_on_device(ds.response, ds.train_mask, "cpu")
    p4, o4, g4 = _fresh(tr, 0)
    _steps(tr, p4, o4, packed, row_valid, g4, 4, scan)

    p, o, g = _fresh(tr, 0)
    _steps(tr, p, o, packed, row_valid, g, 2, scan)
    path = str(tmp_path / "mid.npz")
    ckpt.save_checkpoint(path, ckpt.train_state(p, o), g, step=2)
    pr, orr, gr = _fresh(tr, 5)
    state, gen_state, _, _ = ckpt.load_checkpoint(path,
                                                  ckpt.train_state(pr, orr))
    ckpt.restore_train_state(state, pr, orr)
    gr.set_state(gen_state)
    _steps(tr, pr, orr, packed, row_valid, gr, 2, scan)
    assert _equal_trees(ckpt.train_state(pr, orr), ckpt.train_state(p4, o4))
    assert torch.equal(gr.get_state(), g4.get_state())


@pytest.mark.parametrize("fuse", [True, False])
def test_fit_resume_continues_training(tmp_path, fuse):
    """fit(resume=ckpt) restores params, Adam and the generator and trains
    further: bitwise one uninterrupted fit of the combined length."""
    _, ds = _data(120, 24, seed=6)
    model = _model(num_items=24, use_pallas=True)
    kw = dict(lr=1e-2, eval_every=4, log_every=100, fuse_epochs=fuse)
    full = Trainer(model, TrainConfig(epochs=20, **kw), device="cpu").fit(ds)
    res1 = Trainer(model, TrainConfig(epochs=10, **kw), device="cpu").fit(ds)
    path = str(tmp_path / "mid.npz")
    ckpt.save_checkpoint(path, ckpt.train_state(res1["params"],
                                                res1["optimizer"]),
                         res1["generator"], 10)
    res2 = Trainer(model, TrainConfig(epochs=10, **kw),
                   device="cpu").fit(ds, resume=path)
    assert res2["final_elbo"] == full["final_elbo"]
    assert _equal_trees(ckpt.train_state(res2["params"], res2["optimizer"]),
                        ckpt.train_state(full["params"], full["optimizer"]))
    assert torch.equal(res2["generator"].get_state(),
                       full["generator"].get_state())


def _encode(model, params, ds):
    item_mean = model.item_posterior_mean(params)
    return model.encode(params, torch.from_numpy(ds.response),
                        torch.from_numpy(ds.train_mask), item_mean)


def test_warm_start_transplant_is_function_preserving(tmp_path):
    """A trained mean-field model transplanted into the conditional family
    (zero-filled conditioning rows) computes the same encoder output and
    keeps its item posterior exactly; fit(warm_start=) starts from it."""
    _, ds = _data(96, 20, k=2, seed=11)
    kw = dict(num_items=20, ability_dim=2, use_pallas=True)
    src_model = _model(conditional_posterior=False, **kw)
    Trainer(src_model, TrainConfig(lr=1e-2, epochs=6, eval_every=3,
                                   out_dir=str(tmp_path)),
            device="cpu").fit(ds)
    best = str(tmp_path / "best.npz")
    src = ckpt.load_params_self_describing(best, device="cpu")
    for cond in ("sample", "mean"):
        dst_model = _model(condition_on=cond, **kw)
        tp = ckpt.transplant_params(src, dst_model.init_params(1))
        mu_s, lv_s, _ = _encode(src_model, src, ds)
        mu_d, lv_d, _ = _encode(dst_model, tp, ds)
        np.testing.assert_allclose(mu_d.detach().numpy(),
                                   mu_s.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(lv_d.detach().numpy(),
                                   lv_s.detach().numpy(), atol=1e-6)
        assert _equal_trees(dst_model.item_posterior_mean(tp),
                            src_model.item_posterior_mean(src))
        assert all(t.requires_grad for t in tree_leaves(tp))
    res = Trainer(dst_model, TrainConfig(lr=1e-2, epochs=2, eval_every=2,
                                         warm_start=best),
                  device="cpu").fit(ds)
    assert np.isfinite(res["final_elbo"])


def test_warm_start_rejects_scrambled_transplants(tmp_path):
    src = dict(num_items=20, irt_model="2pl", ability_dim=1, hidden_dim=16,
               conditional_posterior=False, condition_on="sample",
               theta_posterior="diag", num_categories=2,
               item_latent_dim=16, deep_hidden_dim=128, item_encoder=False,
               item_encoder_hidden=64)
    base = dict(num_items=20, hidden_dim=16)
    ckpt.check_transplant_compat(src, VIBOConfig(**base))   # widening: fine
    for dst, match in ((dict(base, ability_dim=4), "ability_dim"),
                       (dict(base, hidden_dim=32), "hidden_dim"),
                       (dict(base, irt_model="3pl"), "irt_model")):
        with pytest.raises(ValueError, match=match):
            ckpt.check_transplant_compat(src, VIBOConfig(**dst))
    with pytest.raises(ValueError, match="conditional -> mean-field"):
        ckpt.check_transplant_compat(
            dict(src, conditional_posterior=True),
            VIBOConfig(**base, conditional_posterior=False))
    # sample <-> mean share layout and semantics
    ckpt.check_transplant_compat(dict(src, conditional_posterior=True),
                                 VIBOConfig(**base, condition_on="mean"))
    # a shape the transplant cannot embed
    narrow, wide = _model(hidden=32), _model(hidden=16)
    with pytest.raises(ValueError, match="transplant failed"):
        ckpt.transplant_params(narrow.init_params(0), wide.init_params(0))

    # through fit: K = 1 -> K = 4 and warm_start with resume refused
    _, ds = _data(64, 20, seed=2)
    Trainer(_model(num_items=20), TrainConfig(lr=1e-2, epochs=4,
                                              eval_every=4,
                                              out_dir=str(tmp_path)),
            device="cpu").fit(ds)
    best = str(tmp_path / "best.npz")
    _, ds4 = _data(64, 20, k=4, seed=2)
    with pytest.raises(ValueError, match="ability_dim"):
        Trainer(_model(num_items=20, ability_dim=4),
                TrainConfig(epochs=2, warm_start=best), device="cpu").fit(ds4)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(_model(num_items=20), TrainConfig(epochs=2, warm_start=best),
                device="cpu").fit(ds, resume=best)


def test_restarts_pick_best_final_elbo(tmp_path):
    _, ds = _data(64, M, seed=4)
    model = _model()
    with pytest.raises(ValueError, match="restarts"):
        Trainer(model, TrainConfig(restarts=0), device="cpu")
    cfg = TrainConfig(lr=1e-2, epochs=4, eval_every=2, restarts=2,
                      out_dir=str(tmp_path))
    res = Trainer(model, cfg, device="cpu").fit(ds)
    finals = [r["final_elbo"] for r in res["restarts"]]
    sel = res["selected_restart"]
    assert sel == int(np.argmax(finals)) and finals[0] != finals[1]
    assert [r["seed"] for r in res["restarts"]] == [0, 1]
    assert res["final_elbo"] == finals[sel]
    single = Trainer(model, dataclasses.replace(cfg, restarts=1, seed=sel,
                                                out_dir=None),
                     device="cpu").fit(ds)
    assert _equal_trees(single["params"], res["params"])
    promoted = (tmp_path / "best.npz").read_bytes()
    assert promoted == (tmp_path / f"restart{sel}" / "best.npz").read_bytes()
    assert (tmp_path / "restart0" / "metrics.jsonl").exists()
    with pytest.raises(ValueError, match="resume"):
        Trainer(model, cfg, device="cpu").fit(ds, resume="x.npz")


def test_metrics_jsonl_has_jax_keys(tmp_path):
    """Both packages' fit(out_dir=) on one config: the same events, each
    with the same keys, in metrics.jsonl and in the history; best.npz's
    extra keys match."""
    sim, ds = _data(64, M, seed=1)
    kw = dict(lr=1e-2, epochs=6, eval_every=3, log_every=2)
    jmodel = JVIBO(JConfig(num_items=M, hidden_dim=16))
    jres = JTrainer(jmodel, JTrainConfig(**kw, out_dir=str(tmp_path / "j"))
                    ).fit(ds, truth=sim)
    res = Trainer(_model(), TrainConfig(**kw, out_dir=str(tmp_path / "t")),
                  device="cpu").fit(ds, truth=sim)

    def records(side):
        lines = (tmp_path / side / "metrics.jsonl").read_text().splitlines()
        return [json.loads(x) for x in lines]

    jrec, rec = records("j"), records("t")
    assert [(r["event"], r["epoch"], sorted(r)) for r in rec] == [
        (r["event"], r["epoch"], sorted(r)) for r in jrec]
    assert [sorted(h) for h in res["history"]] == [
        sorted(h) for h in jres["history"]]
    assert [r.get("step") for r in rec] == [r.get("step") for r in jrec]
    assert set(ckpt.peek_extra(str(tmp_path / "t" / "best.npz"))) == set(
        ckpt.peek_extra(str(tmp_path / "j" / "best.npz")))


@pytest.mark.parametrize("k", [1, 2])
def test_truth_and_posterior_means_match_jax(k):
    """infer_posterior_means (theta, item means, sigma, the diagonal scale
    tril) and the theta_pearson an eval record carries, from one set of
    params in both packages, at 1e-5."""
    sim, ds = _data(70, M, k=k, seed=3)
    jmodel = JVIBO(JConfig(num_items=M, hidden_dim=16, ability_dim=k))
    jparams = jmodel.init_params(jax.random.key(2))
    model = _model(ability_dim=k)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    want = jeval.infer_posterior_means(jmodel, jparams, ds, block_size=32,
                                       return_scale_tril=True)
    got = evaluation.infer_posterior_means(model, params, ds, block_size=32,
                                           return_scale_tril=True)
    assert len(got) == len(want) == 4
    for x, y in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5, atol=1e-6)
    assert set(got[1]) == set(want[1])
    for name in want[1]:
        np.testing.assert_allclose(got[1][name], np.asarray(want[1][name]),
                                   rtol=1e-5, atol=1e-6)
    pj = jeval.correlation(np.asarray(want[0]), sim.theta,
                           align_rotation=True)["pearson"]
    pt = evaluation.correlation(got[0], sim.theta,
                                align_rotation=True)["pearson"]
    assert pt == pytest.approx(pj, rel=1e-5, abs=1e-6)
    # fit(truth=): each eval record's theta_pearson is this correlation of
    # the params at that point
    res = Trainer(model, TrainConfig(lr=1e-2, epochs=4, eval_every=4),
                  device="cpu").fit(ds, truth=sim)
    ev = [h for h in res["history"] if h["event"] == "eval"]
    theta, _ = evaluation.infer_posterior_means(model, res["params"], ds)
    assert ev[-1]["theta_pearson"] == evaluation.correlation(
        theta, sim.theta, align_rotation=True)["pearson"]


@pytest.mark.parametrize("irt_model", ["2pl", "grm"])
def test_from_checkpoint_matches_jax(tmp_path, irt_model):
    """JAX's fit(out_dir=) writes best.npz; the port's from_checkpoint on
    it, and on a port checkpoint of the same params, scores new students
    as JAX's from_checkpoint does (1e-5), the two port scorers bitwise
    equal; resuming a JAX checkpoint is refused."""
    c = 4 if irt_model == "grm" else 2
    _, ds = _data(64, M, seed=5, model=irt_model)
    jcfg = JConfig(num_items=M, hidden_dim=16, irt_model=irt_model,
                   num_categories=c)
    JTrainer(JVIBO(jcfg), JTrainConfig(lr=1e-2, epochs=4, eval_every=2,
                                       out_dir=str(tmp_path))).fit(ds)
    jpath = str(tmp_path / "best.npz")
    rng = np.random.default_rng(0)
    resp = rng.integers(0, c, (40, M)).astype(np.float32)
    mask = (rng.random((40, M)) < 0.8).astype(np.float32)
    want = JScorer.from_checkpoint(jpath).score(resp, mask)
    scorer = AbilityScorer.from_checkpoint(jpath, device="cpu")
    got = scorer.score(resp, mask)
    for key in ("theta_mu", "theta_sigma", "prob"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6)

    # the same params as a port Trainer checkpoint
    model = scorer.model
    params = ckpt.load_params_self_describing(jpath, device="cpu")
    from vibo_tpu_torch.train.trainer import make_optimizer
    tpath = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(
        tpath, ckpt.train_state(params, make_optimizer(params, 1e-2)),
        torch.Generator(), 0,
        extra={"model_cfg": json.dumps(dataclasses.asdict(model.cfg))})
    again = AbilityScorer.from_checkpoint(tpath, device="cpu").score(resp,
                                                                     mask)
    for key in got:
        np.testing.assert_array_equal(again[key], got[key])
    direct = AbilityScorer(model, params, device="cpu").score(resp, mask)
    for key in got:
        np.testing.assert_array_equal(direct[key], got[key])
    with pytest.raises(ValueError, match="cannot be resumed"):
        Trainer(model, TrainConfig(epochs=1), device="cpu").fit(ds,
                                                                resume=jpath)


@pytest.mark.parametrize("family", [
    dict(theta_posterior="chol", condition_on="stats"),
    dict(theta_posterior="laplace-w", condition_on="stats"),
    dict(theta_posterior="laplace", condition_on="mean"),
    dict(theta_posterior="chol", item_encoder=True, item_encoder_hidden=8)])
def test_from_checkpoint_families_match_jax(tmp_path, family):
    """A JAX Trainer checkpoint of each posterior and conditioning family
    (K = 2) loads in the port's from_checkpoint by its embedded config
    and scores new students as JAX's scorer does (the marginal sds of the
    full covariance; the item encoder's posterior from each padded
    scoring batch), at 1e-5."""
    _, ds = _data(64, M, k=2, seed=6)
    jcfg = JConfig(num_items=M, hidden_dim=16, ability_dim=2, **family)
    JTrainer(JVIBO(jcfg), JTrainConfig(lr=1e-2, epochs=4, eval_every=2,
                                       out_dir=str(tmp_path))).fit(ds)
    jpath = str(tmp_path / "best.npz")
    rng = np.random.default_rng(1)
    resp = (rng.random((30, M)) < 0.5).astype(np.float32)
    mask = (rng.random((30, M)) < 0.8).astype(np.float32)
    want = JScorer.from_checkpoint(jpath, pad_multiple=16).score(resp, mask)
    scorer = AbilityScorer.from_checkpoint(jpath, device="cpu",
                                           pad_multiple=16)
    assert dataclasses.asdict(scorer.model.cfg) == dataclasses.asdict(jcfg)
    got = scorer.score(resp, mask)
    for key in ("theta_mu", "theta_sigma", "prob"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6)


def test_warm_start_diag_to_chol_matches_jax():
    """The diag -> chol widening: the port's transplant of a diagonal
    family's params into a chol init equals JAX's transplant of the same
    params into the same init (the head's Cholesky columns zero-filled),
    and the widened model's encoder output has off == 0 and the source's
    (mu, logvar)."""
    from vibo_tpu.train import checkpoint as jckpt
    kw = dict(num_items=M, hidden_dim=16, ability_dim=3,
              condition_on="stats")
    src_j = JVIBO(JConfig(**kw)).init_params(jax.random.key(3))
    dst_j = JVIBO(JConfig(theta_posterior="chol", **kw)).init_params(
        jax.random.key(4))
    jckpt.check_transplant_compat(dataclasses.asdict(JConfig(**kw)),
                                  JConfig(theta_posterior="chol", **kw))
    ckpt.check_transplant_compat(dataclasses.asdict(VIBOConfig(**kw)),
                                 VIBOConfig(theta_posterior="chol", **kw))
    want = jckpt.transplant_params(src_j, dst_j)
    src = params_from_jax(jax.tree.map(np.asarray, src_j), "cpu")
    got = ckpt.transplant_params(
        src, params_from_jax(jax.tree.map(np.asarray, dst_j), "cpu"))
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    _, ds = _data(40, M, k=3, seed=7)
    mu_s, lv_s, off_s = _encode(VIBO(VIBOConfig(**kw), device="cpu"), src, ds)
    mu_d, lv_d, off_d = _encode(
        VIBO(VIBOConfig(theta_posterior="chol", **kw), device="cpu"), got, ds)
    assert off_s is None and off_d.shape == (40, 3)
    assert torch.equal(off_d, torch.zeros_like(off_d))
    np.testing.assert_allclose(mu_d.detach().numpy(), mu_s.detach().numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(lv_d.detach().numpy(), lv_s.detach().numpy(),
                               atol=1e-6)
