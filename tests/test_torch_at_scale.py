"""The port's at-scale pipeline (`vibo_tpu_torch/scripts/`) against the
JAX package's (`scripts/run_at_scale.py`, `scripts/gen_duolingo_csv.py`,
`scripts/bench_ingest.py`), at CPU sizes:

- the generated CSV is byte-equal to the reference generator's;
- on it, load_dataset("duolingo") (native parser), split_persons and
  pack_responses give the JAX package's arrays byte for byte;
- `run(device="cpu")` at 3,000 users x 128 lexemes, hidden 64, S = 2, 300
  epochs in chunks of 100, IWAE-10, prints the reference script's JSON keys
  and passes the gates of tests/test_at_scale.py (the ELBO rises over the
  chunks, held-out accuracy above the base rate, IWAE a cell in (-1, 0),
  new-person accuracy near the base rate);
- the IWAE evaluator at the at-scale model's bf16 encoder equals JAX's on
  the same params and replayed noise;
- tests/at_scale_reference.py's paired mode starts the port from JAX's
  params and steps it on JAX's noise;
- bench_ingest's native and Python paths agree;
- run() ends where an untimed loop of make_scan chunks from the same
  state ends: the same chunk ELBOs, accuracy and IWAE (so its capture
  chunk and one-chunk timing leave no trace in the trained state: the
  initial state is put back in place);
- a native parser that cannot be built raises, in both scripts."""

import ast
import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from vibo_tpu.data.loaders import load_dataset as jload_dataset
from vibo_tpu.data.masking import split_persons as jsplit_persons
from vibo_tpu.ops.pallas_elbo import pack_responses as jpack
from vibo_tpu_torch import evaluation
from vibo_tpu_torch.data import native
from vibo_tpu_torch.data.loaders import load_dataset
from vibo_tpu_torch.data.masking import split_persons
from vibo_tpu_torch.ops.packing import pack_responses
from vibo_tpu_torch.scripts import (bench_ingest, gen_duolingo_csv,
                                    run_at_scale)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import gen_duolingo_csv as jgen  # noqa: E402  (the reference generator)

FIELDS = ("response", "train_mask", "heldout_mask")
SMALL = dict(rows=20_000, users=500, lexemes=64, seed=2)


def _reference_keys() -> set:
    """The keys of the dict the reference script prints (`out = {...}` in
    scripts/run_at_scale.py's main)."""
    tree = ast.parse(open(os.path.join(REPO, "scripts",
                                       "run_at_scale.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "out"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no out = {...} in scripts/run_at_scale.py")


@pytest.fixture(scope="module")
def small_csv(tmp_path_factory):
    """The port's CSV and the reference generator's, at SMALL."""
    root = tmp_path_factory.mktemp("duo")
    ours, ref = root / "port" / "duolingo.csv", root / "ref" / "duolingo.csv"
    gen_duolingo_csv.generate(str(ours), **SMALL)
    jgen.generate(str(ref), **SMALL)
    return ours, ref


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test: beside the suite's other
    xdist workers a pool of every core stalls in its barriers, many times
    slower, and slows those workers too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_csv_byte_equal_to_reference(small_csv):
    ours, ref = small_csv
    assert os.path.getsize(ours) > 100_000
    assert filecmp.cmp(ours, ref, shallow=False)


def test_ingest_split_and_code_equal_to_jax(small_csv):
    ours, _ = small_csv
    assert native.available()
    ds = load_dataset("duolingo", data_dir=str(ours.parent),
                      holdout_frac=0.1, seed=SMALL["seed"])
    jds = jload_dataset("duolingo", data_dir=str(ours.parent),
                        holdout_frac=0.1, seed=SMALL["seed"])
    assert ds.response.shape == (SMALL["users"], SMALL["lexemes"])
    pairs = [(ds, jds), *zip(split_persons(ds, 0.05, SMALL["seed"]),
                             jsplit_persons(jds, 0.05, SMALL["seed"]))]
    for got, want in pairs:
        for f in FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
        assert got.person_ids == want.person_ids
        assert got.item_ids == want.item_ids
    train, jtrain = pairs[1]
    code = pack_responses(train.response, train.train_mask)
    jcode = np.asarray(jpack(jtrain.response, jtrain.train_mask))
    assert code.dtype == jcode.dtype == np.int8
    assert code.tobytes() == jcode.tobytes()


def test_run_on_cpu_gives_reference_keys_and_passes_its_gates(tmp_path,
                                                              one_thread):
    out = run_at_scale.run(str(tmp_path / "duolingo.csv"), rows=150_000,
                           users=3_000, lexemes=128, epochs=300, chunk=100,
                           hidden_dim=64, num_samples=2, new_person_frac=0.05,
                           iwae_samples=10, seed=2, device="cpu")
    assert _reference_keys() <= set(out)
    json.dumps(out)                       # one JSON line
    assert out["epochs"] == 300 and out["items"] == 128
    assert out["persons_train"] + out["persons_new"] > 2_000
    elbos = out["chunk_elbos"]
    assert len(elbos) == 3 and np.isfinite(elbos).all()
    assert elbos[-1] > elbos[0] and out["final_elbo"] == elbos[-1]
    assert out["heldout_acc"] > out["heldout_base_rate"] + 0.01
    assert -1.0 < out["iwae100_loglik_per_cell"] < 0.0
    assert out["new_person_acc"] > out["heldout_base_rate"] - 0.05
    assert out["new_person_persons_per_sec"] > 0
    assert out["device"] == "cpu" and out["peak_hbm_gb"] is None
    # the CSV was written this run; a second run would read it
    assert out["csv_write_s"] is not None
    assert run_at_scale.write_csv(out["csv"], 1, 1, 1, 0) is None


def test_run_ends_where_an_untimed_scan_loop_ends(small_csv, one_thread):
    ours, _ = small_csv
    seed, chunk, n_chunks, iwae_samples = SMALL["seed"], 2, 3, 4
    kw = dict(rows=SMALL["rows"], users=SMALL["users"],
              lexemes=SMALL["lexemes"], hidden_dim=16, num_samples=2,
              new_person_frac=0.05, seed=seed)
    out = run_at_scale.run(str(ours), epochs=chunk * n_chunks, chunk=chunk,
                           iwae_samples=iwae_samples, device="cpu", **kw)
    # the same fit with no warm-up chunk and no timed chunk before it
    train_ds, _, _ = run_at_scale.ingest(
        str(ours), kw["rows"], kw["users"], kw["lexemes"], seed,
        kw["new_person_frac"])
    st = run_at_scale.training_state(train_ds, kw["hidden_dim"], seed,
                                     torch.device("cpu"))
    scan = st["trainer"].make_scan(1.0, kw["num_samples"], chunk)
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    elbos = [float(scan(st["params"], st["optimizer"], st["code"],
                        st["row_valid"], gen)[-1, 0])
             for _ in range(n_chunks)]
    assert elbos == out["chunk_elbos"]
    acc = evaluation.imputation_accuracy(st["model"], st["params"], train_ds)
    iwae_gen = torch.Generator()
    iwae_gen.manual_seed(7)
    iwae = evaluation.iwae_loglik(st["model"], st["params"], train_ds,
                                  num_samples=iwae_samples,
                                  generator=iwae_gen)
    assert acc["acc"] == out["heldout_acc"]
    assert iwae["loglik_per_cell"] == out["iwae100_loglik_per_cell"]


def test_paired_mode_starts_from_jax_and_takes_its_noise(small_csv,
                                                         one_thread):
    """tests/at_scale_reference.py's paired mode at a tiny size (two
    chunks of two steps, f32): the port's first step from JAX's initial
    params on the noise JAX's scan drew gives JAX's ELBO, the noise drawn
    outside the scan is the scan's (JAX's loss on it is the scan's ELBO),
    the chunks' ELBOs stay together, and the port's gradient on JAX's
    state agrees with JAX's leaf by leaf."""
    from at_scale_reference import paired_seed, paired_summary
    ours, _ = small_csv
    size = dict(rows=SMALL["rows"], users=SMALL["users"],
                lexemes=SMALL["lexemes"], hidden_dim=16, num_samples=2,
                epochs=4, iwae_samples=4)
    out = paired_seed(SMALL["seed"], "float32", size, chunk=2, grad_every=1,
                      csv=str(ours))
    jax_first, port_first = out["first_step_elbo"]
    assert abs(port_first - jax_first) <= 1e-4 * abs(jax_first)
    assert out["jax_noise_replay_max_rel"] <= 1e-6
    assert out["epochs"] == 4 and out["grad_points"] == 4
    assert len(out["jax_chunk_elbo"]) == len(out["port_chunk_elbo"]) == 2
    np.testing.assert_allclose(out["port_chunk_elbo"], out["jax_chunk_elbo"],
                               rtol=1e-4)
    assert max(g["rel_l2"] for g in out["grad_gaps"].values()) <= 1e-4
    assert set(out["grad_gaps"]) >= {"encoder/0/w", "item_post/a/mu"}
    json.dumps(out)
    summary = paired_summary([out, {**out, "port_iwae": out["jax_iwae"]}])
    assert summary["iwae"]["se"] is not None
    assert summary["iwae"]["negative"] + summary["iwae"]["positive"] <= 1


def test_iwae_evaluator_matches_jax_with_the_bf16_encoder():
    """The at-scale model's evaluator (2PL, K = 1, bf16 first layer) on the
    same (converted) params and JAX's replayed noise, at 1e-5."""
    import jax
    from jax_noise_replay import replay_noise
    from vibo_tpu import evaluation as jeval
    from vibo_tpu.data import holdout_split, simulate_irt
    from vibo_tpu.models import VIBO as JVIBO, VIBOConfig as JConfig
    from vibo_tpu_torch.convert import params_from_jax
    from vibo_tpu_torch.models import VIBO, VIBOConfig

    n, m, s = 200, 64, 10
    sim = simulate_irt("2pl", n, m, ability_dim=1, seed=2, missing_rate=0.2)
    ds = holdout_split(sim.response, sim.mask, 0.25, seed=1)
    kw = dict(num_items=m, irt_model="2pl", ability_dim=1, hidden_dim=64,
              use_pallas=True, compute_dtype="bfloat16")
    jmodel = JVIBO(JConfig(**kw))
    jparams = jmodel.init_params(jax.random.key(3))
    key = jax.random.key(11)
    want = jeval.iwae_loglik(jmodel, jparams, key, ds, num_samples=s)
    state = {"key": key}

    def noise(block_index, rows):
        state["key"], sub = jax.random.split(state["key"])
        return replay_noise(sub, s, {"a": (m, 1), "b": (m, 1)}, rows, 1)

    got = evaluation.iwae_loglik(
        VIBO(VIBOConfig(**kw), device="cpu"),
        params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"), ds,
        num_samples=s, noise=noise)
    assert got["num_cells"] == want["num_cells"] > 0
    assert got["loglik_per_cell"] == pytest.approx(want["loglik_per_cell"],
                                                   rel=1e-5)


def test_bench_ingest_paths_agree(small_csv):
    ours, _ = small_csv
    out = bench_ingest.run(str(ours))
    assert out["paths_agree"] is True
    assert (out["persons"], out["items"]) == (SMALL["users"],
                                              SMALL["lexemes"])
    assert out["observed_cells"] > 0 and out["native_s"] > 0
    assert "python_s" not in bench_ingest.run(str(ours), skip_python=True)


def test_missing_native_parser_raises(small_csv, monkeypatch):
    ours, _ = small_csv
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        bench_ingest.run(str(ours))
    with pytest.raises(RuntimeError, match="native"):
        run_at_scale.run(str(ours), device="cpu")


def test_default_csv_is_under_build_and_named_by_its_arguments():
    path = run_at_scale.default_csv(2_000_000, 30_000, 2048, 0)
    assert path.startswith(os.path.join(REPO, "build", ""))
    assert path.endswith(os.path.join("r2000000_u30000_l2048_s0",
                                      "duolingo.csv"))
    assert run_at_scale.card(torch.device("cpu")) == "cpu"
