"""The (students, items) device mesh on torch.distributed (counterpart of
`vibo_tpu.parallel.mesh`).

Layout: the world's ranks laid out row-major as (students, items), as
`np.array(devices).reshape(n // item_axis, item_axis)` lays out JAX's
devices: rank r sits at student row r // item_axis and item column
r % item_axis. A students group joins the ranks of one item column (the
axis a data-parallel reduction runs over), an items group those of one
student row (the axis the item-sharded encoder's partial products sum
over). Every rank creates every group, in the same order, as
torch.distributed requires.

Sharding rules, as JAX's shard_map steps have them:
- the response code: students over the students axis, items over the
  items axis (a rank holds its tile; `student_rows`, `item_block`);
- parameters: replicated on every rank, as shard_map's P() in_specs have
  them. JAX's `param_shardings` (item posteriors over the items axis) has
  no storage counterpart here: each rank keeps every parameter, a 2D tile
  slices its item block out of them and its gradient is block-sparse;
- gradients: each rank's loss is its share of the global loss, every
  collective of the forward is `psum` (whose backward sums the cotangent
  over the same group), and the gradients are summed over the world once
  after the backward (`all_reduce_grads`), so clip and Adam run
  identically on every rank.

The backend is NCCL for CUDA ranks and gloo for CPU ranks
(`default_backend`); a caller may name gloo for CUDA tensors. Nothing
switches backend by itself when one fails.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from vibo_tpu_torch._device import resolve_device

STUDENTS, ITEMS = "students", "items"


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(cpu: bool = False) -> torch.device:
    """This process's device: the CPU when asked, else cuda:LOCAL_RANK (the
    variable torchrun sets; 0 without it), made the current card; raises
    where there is no card (resolve_device)."""
    if cpu:
        return torch.device("cpu")
    dev = resolve_device(
        torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))))
    torch.cuda.set_device(dev)
    return dev


def init_distributed(device, backend: str | None = None,
                     init_method: str = "env://") -> None:
    """torch.distributed.init_process_group for this rank on `device`:
    the backend of default_backend unless named, the rank and world size
    from the environment torchrun sets (env://)."""
    dist.init_process_group(backend=backend or default_backend(device),
                            init_method=init_method)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the (students, items) mesh: the axis sizes, the
    world ranks it spans (row-major), this rank's place in it (rank: its
    index among them, 0 the mesh's writer) and coordinates, the group of
    each axis it belongs to, the mesh's whole group and the device it
    computes on."""
    shape: dict
    ranks: tuple
    rank: int
    student_index: int
    item_index: int
    students: object           # process group: this rank's item column
    items: object              # process group: this rank's student row
    world: object              # process group: every rank
    device: torch.device
    backend: str

    @property
    def num_students(self) -> int:
        return self.shape[STUDENTS]

    @property
    def num_items(self) -> int:
        return self.shape[ITEMS]

    def student_rows(self, n: int) -> tuple[int, int]:
        """[start, end) of this rank's rows of `n` rows padded to a
        multiple of the students axis (pad_rows)."""
        per = pad_rows(n, self.num_students) // self.num_students
        return self.student_index * per, (self.student_index + 1) * per

    def item_block(self, m: int) -> tuple[int, int]:
        """[start, end) of this rank's item block of `m` items (m divisible
        by the items axis)."""
        if m % self.num_items:
            raise ValueError(f"{m} items do not divide over "
                             f"{self.num_items} item shards")
        per = m // self.num_items
        return self.item_index * per, (self.item_index + 1) * per


def pad_rows(n: int, multiple: int) -> int:
    """n rounded up to a multiple of `multiple`."""
    return n + (-n) % multiple


def make_mesh(item_axis: int = 1, backend: str | None = None,
              device=None, ranks=None) -> Mesh | None:
    """A ('students', 'items') mesh over the initialised torch.distributed
    world's `ranks` (None: all of them; JAX's `devices`): item_axis ranks
    of each student row hold item blocks, the rest are the students
    (data-parallel) axis. Default: every rank data-parallel. Every rank of
    the world calls it (the groups are made collectively); a rank outside
    `ranks` gets None.

    backend: the new groups' backend (None: the world's). device: this
    rank's device (None: cuda:LOCAL_RANK, as every entry point of the
    package takes the card unless the caller asks for the CPU; the backend
    never decides it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (init_distributed)")
    ranks = tuple(range(dist.get_world_size()) if ranks is None
                  else sorted(ranks))
    n = len(ranks)
    if n % item_axis != 0:
        raise ValueError(f"{n} devices not divisible by item_axis={item_axis}")
    n_s = n // item_axis
    me = dist.get_rank()
    backend = backend or dist.get_backend()
    students = items = None
    for col in range(item_axis):
        members = [ranks[s * item_axis + col] for s in range(n_s)]
        g = dist.new_group(members, backend=backend)
        if me in members:
            students = g
    for row in range(n_s):
        members = [ranks[row * item_axis + c] for c in range(item_axis)]
        g = dist.new_group(members, backend=backend)
        if me in members:
            items = g
    world = dist.new_group(list(ranks), backend=backend)
    if me not in ranks:
        return None
    pos = ranks.index(me)
    if device is None:
        device = rank_device()
    return Mesh({STUDENTS: n_s, ITEMS: item_axis}, ranks, pos,
                pos // item_axis, pos % item_axis, students, items, world,
                torch.device(device), backend)


def group_size(group) -> int:
    """The ranks of a group; 1 for None (no mesh axis)."""
    return 1 if group is None else dist.get_world_size(group)


class _PSum(torch.autograd.Function):
    """SUM all-reduce over a group; its backward is the same all-reduce of
    the cotangent (every rank's loss reads the sum, so each input's
    gradient is the sum of the cotangents the ranks hand back)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of x over the group's ranks (JAX's lax.psum);
    identity for group None."""
    if group is None:
        return x
    return _PSum.apply(x, group)


@torch.no_grad()
def all_reduce_sum(values, group) -> list:
    """Non-differentiable sums over the group of reported scalars (0-d
    tensors), one collective for all of them; returned detached."""
    flat = torch.stack([v.detach().float() for v in values])
    if group is not None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return list(flat.unbind())


@torch.no_grad()
def all_reduce_grads(leaves: list, group) -> None:
    """Sum every leaf's gradient over the group, in place, as one flat
    buffer (a leaf without a gradient gets zeros)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for p, g in zip(leaves, grads):
        n = g.numel()
        p.grad = flat[off:off + n].view_as(g)
        off += n


@torch.no_grad()
def broadcast_params(leaves: list, mesh: Mesh) -> None:
    """The mesh's first rank's values into every rank's leaves, in place."""
    flat = torch.cat([p.detach().reshape(-1) for p in leaves])
    dist.broadcast(flat, src=mesh.ranks[0], group=mesh.world)
    off = 0
    for p in leaves:
        n = p.numel()
        p.copy_(flat[off:off + n].view_as(p))
        off += n
