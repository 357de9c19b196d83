"""The launch plan of the port's one-pass training loglik kernels and of the
masked loglik's forward and VJP (`vibo_tpu_torch.ops.one_pass.split_plan`):
at odd shapes and sample counts, its student blocks, item splits (and
samples) cover every (sample, student, item) cell exactly once with no empty
split, it cuts a large matrix into about TARGET_BLOCKS blocks, and the
wrappers (`pallas_elbo.loglik_train_cuda`, `pallas_elbo.masked_fwd_cuda`,
`pallas_elbo.masked_bwd_cuda`, `pallas_grm.train_cuda`) hand the kernel that
plan with scratch sized from it (GRM: and the slot table of its prologue).
The wrappers run here against a stand-in for the C entry point, since the
kernels run only on the card (`chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from vibo_tpu_torch.ops import one_pass, pallas_elbo, pallas_grm

SHAPES = [(1, 1), (63, 65), (64, 64), (65, 127), (777, 301), (1000, 300),
          (40, 130), (10240, 1024), (5520, 680), (3, 4096), (4096, 7)]


def _tiles(plan, split, m):
    """The item tiles split `split` covers, as the kernels walk them
    (csrc/loglik_tile.cuh)."""
    ntiles = -(-m // one_pass.ITEMS_PER_TILE)
    lo = split * plan.tiles_per_split
    return range(lo, min(lo + plan.tiles_per_split, ntiles))


def _covered(bsz, m, plan):
    """How often the plan's (block, split) pairs cover each cell."""
    count = np.zeros((bsz, m), np.int32)
    tbs, tmi = one_pass.STUDENTS_PER_BLOCK, one_pass.ITEMS_PER_TILE
    for blk in range(plan.blocks):
        rows = slice(blk * tbs, (blk + 1) * tbs)
        for split in range(plan.splits):
            tiles = _tiles(plan, split, m)
            assert len(tiles) > 0, f"split {split} of {plan} is empty"
            for t in tiles:
                count[rows, t * tmi:(t + 1) * tmi] += 1
    return count


@pytest.mark.parametrize("bsz,m", SHAPES)
def test_split_plan_covers_every_cell_once(bsz, m):
    plan = one_pass.split_plan(bsz, m)
    assert plan.blocks == -(-bsz // one_pass.STUDENTS_PER_BLOCK)
    assert (_covered(bsz, m, plan) == 1).all()


def test_split_plan_fills_a_large_matrix_and_keeps_runs_for_small_ones():
    big = one_pass.split_plan(10240, 1024)
    assert big.blocks * big.splits >= 0.75 * one_pass.TARGET_BLOCKS
    assert big.blocks * big.splits <= 1.25 * one_pass.TARGET_BLOCKS
    # more students than the target: one split, every block walks all items
    assert one_pass.split_plan(200_000, 512).splits == 1
    # no items: one empty split; no students: no blocks
    assert one_pass.split_plan(10, 0) == one_pass.Plan(1, 1, 1)
    assert one_pass.split_plan(0, 10).blocks == 0


class _Recorder:
    """Stands in for a C entry point: keeps its arguments and the launch
    counter's variant."""

    def __init__(self):
        self.args = None
        self.variant = None

    def __call__(self, *args, variant=None):
        self.args = args
        self.variant = variant


@pytest.fixture
def record_scratch(monkeypatch):
    """Shapes of every tensor the wrappers allocate, and a stream stand-in
    so they run on CPU tensors."""
    shapes = []
    empty = torch.empty

    def recording_empty(shape, **kw):
        shapes.append(tuple(shape))
        return empty(shape, **kw)
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    return shapes


@pytest.mark.parametrize("link", ["2pl", "3pl"])
@pytest.mark.parametrize("per_person", [False, True])
def test_binary_wrapper_sizes_its_scratch_from_the_plan(link, per_person,
                                                        record_scratch,
                                                        monkeypatch):
    bsz, m, k = 777, 301, 3
    plan = one_pass.split_plan(bsz, m)
    rec = _Recorder()
    monkeypatch.setattr(pallas_elbo, "TRAIN" if link == "2pl"
                        else "TRAIN_3PL", rec)
    theta = torch.zeros((bsz, k))
    g_hat = torch.zeros(m) if link == "3pl" else None
    pallas_elbo.loglik_train_cuda(theta, torch.zeros((m, k)), torch.zeros(m),
                                  g_hat, torch.zeros((bsz, m), dtype=torch.int8),
                                  torch.zeros((bsz, k)), per_person)
    assert rec.args[-7:-1] == (bsz, m, k, *plan)
    # the launch is counted by the op it serves: theta (B, K) or (K, B)
    assert rec.variant == ("bk" if per_person else "kb")
    want = {(plan.splits, bsz, k), (plan.blocks, m, k), (plan.blocks, m),
            (plan.splits, plan.blocks)}
    if per_person:
        want.add((plan.splits, bsz))
    assert want <= set(record_scratch)
    assert not any(s[0] not in (plan.blocks, plan.splits, bsz, m, 1)
                   for s in record_scratch)


@pytest.mark.parametrize("c", [3, 9])
def test_categorical_wrapper_sizes_its_scratch_from_the_plan(c,
                                                             record_scratch):
    bsz, m, k = 1000, 300, 2
    plan = one_pass.split_plan(bsz, m)
    rec = _Recorder()
    ll, dth, da, dk = pallas_grm.train_cuda(
        rec, torch.zeros((bsz, k)), torch.zeros((m, k)),
        torch.zeros((m, c - 1)), torch.zeros((bsz, m), dtype=torch.int8))
    assert rec.args[-8:-1] == (bsz, m, k, c, *plan)
    assert {(plan.splits, bsz, k), (plan.splits, bsz),
            (plan.blocks, k + c - 1, m)} <= set(record_scratch)
    assert da.shape == (m, k) and dk.shape == (m, c - 1)
    assert ll.shape == (bsz,) and dth.shape == (bsz, k)


@pytest.mark.parametrize("bsz,m", SHAPES)
@pytest.mark.parametrize("samples", [1, 3, 5])
def test_masked_vjp_plan_covers_every_cell_once(bsz, m, samples):
    """The VJP's grid (blocks, splits, samples): each sample's blocks and
    splits cover its cells once, so every (sample, student, item) cell is
    taken exactly once, with no empty split."""
    plan = one_pass.split_plan(bsz, m, samples=samples)
    assert plan.blocks == -(-bsz // one_pass.STUDENTS_PER_BLOCK)
    count = np.stack([_covered(bsz, m, plan) for _ in range(samples)])
    assert count.shape == (samples, bsz, m) and (count == 1).all()


def test_masked_vjp_plan_fills_the_card_at_the_minibatch_shape():
    """The minibatch (4,096 x 1,024) gets about TARGET_BLOCKS blocks with
    one sample and with the IWAE steps' five; more samples, fewer splits."""
    for samples in (1, 5):
        plan = one_pass.split_plan(4096, 1024, samples=samples)
        blocks = plan.blocks * plan.splits * samples
        assert 0.75 * one_pass.TARGET_BLOCKS <= blocks
        assert blocks <= 1.25 * one_pass.TARGET_BLOCKS
    assert (one_pass.split_plan(4096, 1024, samples=5).splits
            < one_pass.split_plan(4096, 1024).splits)


@pytest.mark.parametrize("link", ["2pl", "3pl"])
@pytest.mark.parametrize("reader", ["dense", "int8"])
@pytest.mark.parametrize("samples,shared", [(1, False), (3, False),
                                            (3, True)])
def test_masked_wrapper_sizes_its_scratch_from_the_plan(link, reader,
                                                        samples, shared,
                                                        record_scratch,
                                                        monkeypatch):
    bsz, m, k = 4000, 700, 3
    plan = one_pass.split_plan(bsz, m, samples=samples)
    rec = _Recorder()
    monkeypatch.setattr(pallas_elbo, "MASKED_BWD" if link == "2pl"
                        else "MASKED_BWD_3PL",
                        lambda *args, variant: rec(*args))
    sa = 1 if shared else samples
    g_hat = torch.zeros((sa, m)) if link == "3pl" else None
    data = ((torch.zeros((1, bsz, m)), torch.zeros((1, bsz, m)), None)
            if reader == "dense"
            else (None, None, torch.zeros((1, bsz, m), dtype=torch.int8)))
    grads = pallas_elbo.masked_bwd_cuda(
        torch.zeros((samples, bsz)), torch.zeros((samples, bsz, k)),
        torch.zeros((sa, m, k)), torch.zeros((sa, m)), g_hat, *data)
    assert rec.args[-8:-1] == (samples, bsz, m, k, *plan)
    want = {(plan.splits, samples, bsz, k), (plan.blocks, samples, m, k),
            (plan.blocks, samples, m)}
    assert want <= set(record_scratch)
    assert grads[0].shape == (samples, bsz, k)
    assert grads[1].shape == (sa, m, k) and grads[2].shape == (sa, m)
    assert len(grads) == (4 if link == "3pl" else 3)


@pytest.mark.parametrize("link", ["2pl", "3pl"])
@pytest.mark.parametrize("reader", ["dense", "int8"])
@pytest.mark.parametrize("samples,shared", [(1, False), (3, False),
                                            (3, True)])
def test_masked_fwd_wrapper_sizes_its_scratch_from_the_plan(link, reader,
                                                            samples, shared,
                                                            record_scratch,
                                                            monkeypatch):
    """The forward runs on the VJP's plan: (blocks, splits, samples), with
    each split's ll of every (sample, student) in part_ll, which the second
    pass sums into ll (S, B)."""
    bsz, m, k = 4000, 700, 3
    plan = one_pass.split_plan(bsz, m, samples=samples)
    rec = _Recorder()
    monkeypatch.setattr(pallas_elbo, "MASKED_FWD" if link == "2pl"
                        else "MASKED_FWD_3PL",
                        lambda *args, variant: rec(*args))
    sa = 1 if shared else samples
    g_hat = torch.zeros((sa, m)) if link == "3pl" else None
    data = ((torch.zeros((1, bsz, m)), torch.zeros((1, bsz, m)), None)
            if reader == "dense"
            else (None, None, torch.zeros((1, bsz, m), dtype=torch.int8)))
    ll = pallas_elbo.masked_fwd_cuda(
        torch.zeros((samples, bsz, k)), torch.zeros((sa, m, k)),
        torch.zeros((sa, m)), g_hat, *data)
    assert rec.args[-8:-1] == (samples, bsz, m, k, *plan)
    assert (plan.splits, samples, bsz) in record_scratch
    assert ll.shape == (samples, bsz)
    assert not any(s[0] not in (plan.splits, samples)
                   for s in record_scratch)


@pytest.mark.parametrize("c,k", [(3, 2), (5, 4), (8, 8), (9, 4), (5, 9)])
def test_grm_wrapper_sizes_its_slot_table(c, k, record_scratch, monkeypatch):
    """GRM gets the table its prologue writes (at C <= 8, K <= 8), one
    16-byte slot for each category of each item of each 64-item tile; GPCM
    gets none."""
    bsz, m = 1000, 300
    rec = _Recorder()
    monkeypatch.setattr(pallas_grm, "TRAIN", rec)
    pallas_grm.train_cuda(rec, torch.zeros((bsz, k)), torch.zeros((m, k)),
                          torch.zeros((m, c - 1)),
                          torch.zeros((bsz, m), dtype=torch.int8))
    n = -(-m // one_pass.ITEMS_PER_TILE) * c * one_pass.ITEMS_PER_TILE * 4
    assert pallas_grm.slot_table_floats(m, c) == n
    assert (n,) in record_scratch
    assert rec.args[5] is not None
    gpcm = _Recorder()
    pallas_grm.train_cuda(gpcm, torch.zeros((bsz, k)), torch.zeros((m, k)),
                          torch.zeros((m, c - 1)),
                          torch.zeros((bsz, m), dtype=torch.int8))
    assert gpcm.args[5] is None
