"""Meshes: the training meshes over a process group, and the transcode
mesh's shard slots.

Port of ``repro.launch.mesh``.

**Training meshes.**  The reference's mesh is a ``jax.sharding.Mesh``:
named axes over devices, one process driving them all.  Here a rank is
one process and :class:`Mesh` is named axes over the ranks of
``torch.distributed``'s process group, row-major (rank ``r`` of a
``(data, model)`` mesh sits at ``(r // model, r % model)``).  It holds
the axis sizes in order (``shape``, as ``jax.sharding.Mesh.shape``),
this rank's coordinate, and one process group for every set of axes a
collective can run over: each axis, each pair (``("pod", "data")``, the
data axes of a multi-pod mesh) and the whole mesh, and, along each axis,
every block of ``g`` consecutive ranks for each ``g`` that divides the
axis (``Mesh.block``: the ranks that share one KV head over the model
axis), and the other axes together with each such block of the last
axis (``Mesh.data_block``: the data ranks and the model ranks that
share a KV head, over which a decode cache split in slot blocks
combines its attention).  A group whose axes have size 1 is ``None``: a
collective over it is the identity and is not issued.  The sharding specs
(``train.sharding``) read only ``shape``,
so they run unchanged on an **abstract** mesh: one with no coordinate
and no groups, as ``make_production_mesh`` returns outside the dry run.

``make_host_mesh`` is the launcher's mesh over the initialised process
group, ``(world // model, model)``, as the reference's over its host's
devices; without a process group it is ``(1, 1)`` with no groups.

**Transcode mesh.**  The reference's mesh
is a 1-D ``jax.sharding.Mesh`` over devices on one ``"data"`` axis, and
``shard_map`` runs one launch per device.  Here a shard is a **slot on
one device**: on a CUDA device each slot owns a ``torch.cuda.Stream``,
so the shards' launches can run side by side on the card; on the CPU a
slot has no stream and the shards run one after another.

A slot is a stream, not a device, so any count of slots fits on one
card: the reference's check that ``n_shards`` does not exceed the
devices has no counterpart.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import runtime


@dataclasses.dataclass(frozen=True)
class TranscodeMesh:
    """Shard slots on one device: slot ``k`` runs shard ``k`` on
    ``streams[k]`` (``None`` on the CPU)."""

    device: torch.device
    streams: Tuple[Optional["torch.cuda.Stream"], ...]
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def n_shards(self) -> int:
        return len(self.streams)

    @property
    def shape(self) -> dict:
        """Axis sizes, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.n_shards}


def make_transcode_mesh(n_shards=None, *, device=None) -> TranscodeMesh:
    """1-D ``"data"`` mesh of ``n_shards`` slots on ``device`` (the
    current CUDA device unless the caller asks otherwise).  ``None``
    means one slot per visible CUDA device, the reference's every
    device; on the CPU that is one."""
    dev = runtime.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n_shards is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    else:
        n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if dev.type == "cuda":
        streams = tuple(torch.cuda.Stream(device=dev) for _ in range(n))
    else:
        streams = (None,) * n
    return TranscodeMesh(dev, streams)


# ---------------------------------------------------------------------------
# Training meshes


@dataclasses.dataclass(eq=False)
class Mesh:
    """Named axes over ranks.  ``shape``: axis name -> size, in order;
    ``coord``: this rank's index on each axis (``None`` for an abstract
    mesh, or on a rank outside the mesh); ``groups``: a tuple of axis
    names (in mesh order) -> the process group of this rank's peers
    along those axes, ``None`` where they number one; ``blocks``:
    ``(axis, g)`` -> the group of this rank's block of ``g`` consecutive
    indices along ``axis`` (the other coordinates fixed), for each ``g``
    that divides the axis, ``1 < g <`` its size, and ``(rest, axis, g)``
    -> the group of every index of the axes ``rest`` before the last axis
    ``axis`` with this rank's block of ``g`` of it (``data_block``)."""

    shape: dict
    coord: Optional[dict] = None
    groups: dict = dataclasses.field(default_factory=dict)
    blocks: dict = dataclasses.field(default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (``None``, a name or names) as a tuple in mesh order."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        order = self.axis_names
        if list(names) != sorted(names, key=order.index):
            raise ValueError(f"axes {names} are not in the mesh's order "
                             f"{order}")
        return names

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major coordinate over ``axes``."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coord[a]
        return i

    def group(self, axes):
        """The process group over ``axes`` (``None``: size 1)."""
        return self.groups[self.axes(axes)]

    def block(self, axis: str, g: int):
        """``(group, index in it)``: the process group of this rank's block
        of ``g`` consecutive indices along ``axis``, the whole axis's group
        when ``g`` is its size, ``None`` when ``g`` is 1."""
        if g == self.shape[axis]:
            return self.group(axis), self.coord[axis]
        return (None if g == 1 else self.blocks[(axis, g)],
                self.coord[axis] % g)

    def data_block(self, axes, axis: str, g: int):
        """``(group, index in it)``: the ranks of every index of ``axes``
        (the axes before the last, ``axis``) with this rank's block of
        ``g`` consecutive indices of ``axis``; the index is ``h * g + a``,
        ``h`` this rank's over ``axes`` and ``a`` its place in the
        block (the group's ranks in ascending order)."""
        axes = self.axes(axes)
        h, a = self.index(axes), self.coord[axis] % g
        if g == 1:
            return self.group(axes), h
        if g == self.shape[axis]:
            return self.group(axes + (axis,)), h * g + a
        if self.axis_size(axes) == 1:
            return self.blocks[(axis, g)], a
        return self.blocks[(axes, axis, g)], h * g + a


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``torch.distributed``'s all-gather into one tensor (its
    ``all_gather_single`` where this torch has it)."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``torch.distributed``'s sum-reduce-scatter of one tensor (its
    ``reduce_scatter_single`` where this torch has it)."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def make_mesh(shape: dict, ranks=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` (axis name -> size, in order) over
    ``ranks`` (global ranks, row-major; the first of the process group's
    unless given).  Every rank of the group must call it, in the same
    order: it creates the sub-groups, which
    ``torch.distributed.new_group`` makes a collective call."""
    if ranks is None:
        ranks = range(math.prod(shape.values()))
    ranks = tuple(ranks)
    names = tuple(shape)
    sizes = [shape[a] for a in names]
    me = dist.get_rank()
    coord = None
    if me in ranks:
        flat, coord = ranks.index(me), {}
        for a, n in zip(reversed(names), reversed(sizes)):
            coord[a] = flat % n
            flat //= n
        coord = {a: coord[a] for a in names}
    world = dist.get_world_size()

    def rank_at(at):
        flat = 0
        for a in names:
            flat = flat * shape[a] + at[a]
        return ranks[flat]
    groups = {}
    for k in range(1, len(names) + 1):
        for sub in itertools.combinations(names, k):
            n = math.prod(shape[a] for a in sub)
            rest = [a for a in names if a not in sub]
            mine = None
            for fixed in itertools.product(*(range(shape[a]) for a in rest)):
                at = dict(zip(rest, fixed))
                members = []
                for free in itertools.product(*(range(shape[a])
                                                for a in sub)):
                    at.update(zip(sub, free))
                    members.append(rank_at(at))
                if n == 1:
                    continue
                if len(members) == world:
                    g = dist.group.WORLD
                else:
                    g = dist.new_group(members)
                if coord is not None and me in members:
                    mine = g
            groups[sub] = mine
    if coord is not None and len(ranks) == world:
        # the whole mesh is the world: its group is issued even at size 1
        groups[names] = dist.group.WORLD
    blocks = {}
    for a in names:
        rest = [x for x in names if x != a]
        for g in range(2, shape[a]):
            if shape[a] % g:
                continue
            mine = None
            for fixed in itertools.product(*(range(shape[x]) for x in rest)):
                at = dict(zip(rest, fixed))
                for b0 in range(0, shape[a], g):
                    members = [rank_at({**at, a: i})
                               for i in range(b0, b0 + g)]
                    grp = dist.new_group(members)
                    if coord is not None and me in members:
                        mine = grp
            blocks[(a, g)] = mine
    # the axes before the last, each with a block of the last
    *rest, last = names
    rest = tuple(rest)
    if rest and math.prod(shape[x] for x in rest) > 1:
        for g in range(2, shape[last]):
            if shape[last] % g:
                continue
            mine = None
            for b0 in range(0, shape[last], g):
                members = [rank_at({**dict(zip(rest, at)), last: i})
                           for at in itertools.product(
                               *(range(shape[x]) for x in rest))
                           for i in range(b0, b0 + g)]
                grp = dist.new_group(sorted(members))
                if coord is not None and me in members:
                    mine = grp
            blocks[(rest, last, g)] = mine
    return Mesh(dict(shape), coord, groups, blocks)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).

    Abstract (no groups) unless a process group of that size is
    initialised, as the dry run's fake one is."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    n = math.prod(shape.values())
    if dist.is_initialized() and dist.get_world_size() == n:
        return make_mesh(shape, range(n))
    return Mesh(shape)


def make_host_mesh(n_devices=None, model: int = 2) -> Mesh:
    """``(n // model, model)`` over the ranks of the initialised process
    group, ``n`` its world size unless given and ``model`` at most
    ``n``.  Without a process group: ``(1, 1)``, no groups."""
    if not dist.is_initialized():
        return Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0})
    n = n_devices or dist.get_world_size()
    model = min(model, n)
    data = n // model
    return make_mesh({"data": data, "model": model}, range(data * model))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') when a pod axis exists."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def largest_submesh(shape, failed: int):
    """Elastic scaling helper: biggest (data, model) grid from the
    surviving chips after ``failed`` failures, keeping the model axis
    (TP requires full ICI groups, so we shrink the data axis)."""
    data, model = shape[-2], shape[-1]
    chips = int(math.prod(shape)) - failed
    new_data = chips // model
    return (new_data, model)
