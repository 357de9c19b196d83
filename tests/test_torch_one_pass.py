"""The launch plan of the port's one-pass training loglik kernels
(`vibo_tpu_torch.ops.one_pass.split_plan`): at odd shapes, its student blocks
and item splits cover every (student, item) cell of the code exactly once
with no empty split, it cuts a large matrix into about TARGET_BLOCKS blocks,
and both wrappers (`pallas_elbo.loglik_train_cuda`, `pallas_grm.train_cuda`)
hand the kernel that plan with scratch sized from it. The wrappers run here
against a stand-in for the C entry point, since the kernels run only on the
card (`chip_smoke.py`)."""

import numpy as np
import pytest
import torch

from vibo_tpu_torch.ops import one_pass, pallas_elbo, pallas_grm

SHAPES = [(1, 1), (63, 65), (64, 64), (65, 127), (777, 301), (1000, 300),
          (40, 130), (10240, 1024), (5520, 680), (3, 4096), (4096, 7)]


def _tiles(plan, split, m):
    """The item tiles split `split` covers, as the kernels walk them
    (csrc/loglik_{train,categorical}.cu)."""
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
    """Stands in for a C entry point: keeps its integer arguments."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args


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
