"""The launch plan of the kernels that share the tile mapping of
`csrc/loglik_tile.cuh`: the one-pass training logliks (`csrc/loglik_train.cu`,
`csrc/loglik_grm.cu`, `csrc/loglik_gpcm.cu`) and the masked loglik's
forward and VJP (`csrc/masked_loglik.cu`): blocks of STUDENTS_PER_BLOCK
students, items in tiles of ITEMS_PER_TILE, and the tiles cut into runs
(splits), one run for each block of the grid's second dimension (the masked
loglik's third dimension runs its samples). Each split writes its own
partial of the per-student sums (ll, dtheta) and each student block its own
partial of the per-item sums, which a second pass adds in a fixed order.
What bounds a plan is the card's 132 SMs, two blocks of 16 warps resident
on each: too few blocks leave SMs idle, too short runs pay each block's
start (theta, the first tile's latency) more often. The kernels check the
plan they are given and refuse any other, so the scratch sized from it here
cannot be overrun."""

from __future__ import annotations

from typing import NamedTuple

STUDENTS_PER_BLOCK = 64     # TBS in csrc/loglik_tile.cuh
ITEMS_PER_TILE = 64         # TMI in csrc/loglik_tile.cuh
# Blocks a large matrix is cut into: four for each of an H100's 132 SMs,
# two resident at a time. At the flagship (10,240 x 1,024) that is 4 splits
# of 4 tiles; 2, 6, 8 and 16 splits were slower on the card (PERF.md):
# shorter runs pay a block's start (theta, the first tile's latency) more
# often, fewer blocks leave SMs idle in the last wave.
TARGET_BLOCKS = 4 * 132


class Plan(NamedTuple):
    blocks: int             # student blocks: ceil(B / STUDENTS_PER_BLOCK)
    splits: int             # runs of item tiles, none empty
    tiles_per_split: int    # tiles a run (the last run may be shorter)


def split_plan(bsz: int, m: int, samples: int = 1) -> Plan:
    """The plan of a (bsz, m) code, for `samples` samples a launch: as many
    splits as bring the grid (blocks x splits x samples) to about
    TARGET_BLOCKS blocks, at most one a tile, then the fewest splits of
    that run length (so none is empty)."""
    nblk = -(-bsz // STUDENTS_PER_BLOCK)
    ntiles = -(-m // ITEMS_PER_TILE)
    if ntiles == 0:
        return Plan(nblk, 1, 1)
    want = min(ntiles, max(1, -(-TARGET_BLOCKS // max(nblk * samples, 1))))
    tps = -(-ntiles // want)
    return Plan(nblk, -(-ntiles // tps), tps)
