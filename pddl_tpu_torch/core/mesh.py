"""The port's mesh: which processes form each axis (the port of
:mod:`pddl_tpu.core.mesh`).

The port keeps one process per device, so a mesh is a set of processes,
each driving one card:

- ``tf.distribute.MirroredStrategy`` (``imagenet-resnet50-mirror.py:21``)
  → the processes of this host;
- ``MultiWorkerMirroredStrategy`` (``imagenet-resnet50-multiworkers.py:16-25``)
  → every process of the job, after :func:`pddl_tpu_torch.core.dist.initialize`;
- Horovod's rank/size world (``imagenet-resnet50-hvd.py:16``) → the same;
  ranks are positions along the ``data`` axis.

:func:`build_mesh` returns a :class:`Mesh` record: the axis sizes, the
ranks along the data axis in replica order, the data axis's process group
and this process's device. Over the whole job the mesh takes every
canonical axis: ranks follow JAX's row-major device order (the last axis
varies fastest, so with ``data x model x expert`` a rank is
``d·(model·expert) + m·expert + e``), and each axis of size above 1 gets
the process group of the ranks that differ only along it
(:attr:`Mesh.groups`; :attr:`Mesh.group` stays the ``data`` axis's).
With a ``seq`` axis above 1 the ranks that differ only in ``data`` and
``seq`` form one more group, :attr:`Mesh.batch_group`: a
sequence-sharded batch's processes, over which the gradient and the
logs are averaged. Every combination of axes runs, a ``seq`` axis beside
``model``, ``expert`` or ``stage`` too (ring attention over ``seq`` with
the heads sharded over ``model``, routed experts over ``expert``, or the
stages of a pipeline over ``stage``). ``tdist.new_group`` is a collective
call, so every process of the job creates every group, in the same
order: the mesh over the job, or with ``local_only`` every host's mesh
over its processes (each process keeps its host's). A mesh of chosen
ranks is built by its members only (each line's group by the ranks of
the line, ``use_local_synchronization``), and a line's group is made
once per process and reused by a later mesh over the same ranks. Its
ranks come in increasing order: a torch process group orders its members
by rank, so a line's positions are its ranks' order (JAX's
``build_mesh`` over chosen devices takes any order). ``mesh_context``,
``shard_map``
and ``has_vma_checking`` are JAX mechanics (an ambient mesh, per-shard tracing, the varying-axes checker)
with no counterpart here: a process runs its own replica's code, and
collectives name a process group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from pddl_tpu_torch.core import dist
from pddl_tpu_torch.device import resolve_device

# Canonical axis names, in canonical order.
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"  # pipeline parallelism (GPipe microbatch pipeline)
CANONICAL_AXES = (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS, STAGE_AXIS)

# The data and seq axes together: the processes of one sequence-sharded
# batch (``Mesh.batch_group``).
BATCH_PLANE = "data+seq"


def local_device_count() -> int:
    """Devices this process can drive: the cards it sees (one process
    drives one of them, ``cuda:{local_rank}``), or 1 on a host without a
    card, where the process is its own device (the CPU), as JAX counts
    its one CPU device."""
    return torch.cuda.device_count() or 1


def global_device_count() -> int:
    """Devices across the job (the "world size" analogue). The port runs
    one process per device, so this is the process group's world size: 1
    with no process group."""
    return dist.process_count()


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape.

    Any axis may be ``-1`` meaning "all remaining devices". Axes of size 1
    are kept in the mesh (they cost nothing and keep sharding rules uniform
    across strategies).

    Example::

        MeshConfig(data=-1)                  # pure data parallel
        MeshConfig(data=-1, model=2)         # DP x TP
        MeshConfig(data=2, seq=4)            # DP x sequence parallel
    """

    data: int = -1
    model: int = 1
    seq: int = 1
    expert: int = 1
    stage: int = 1
    # Restrict to this process's local devices (mirrored strategy) instead of
    # the global device set (multi-worker).
    local_only: bool = False

    def axis_sizes(self, n_devices: int) -> dict[str, int]:
        sizes = {
            DATA_AXIS: self.data,
            MODEL_AXIS: self.model,
            SEQ_AXIS: self.seq,
            EXPERT_AXIS: self.expert,
            STAGE_AXIS: self.stage,
        }
        for name, s in sizes.items():
            if s == 0 or s < -1:
                raise ValueError(f"mesh axis {name!r} size must be >= 1 or -1, got {s}")
        wildcard = [name for name, s in sizes.items() if s == -1]
        if len(wildcard) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wildcard}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcard:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh shape {sizes} needs {fixed} devices, have {n_devices}"
            )
        return sizes


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh of processes.

    ``ranks`` are the global ranks along the data axis through this
    process, in replica order, ``group`` the process group over them
    (``None`` when the axis has one member and needs no collective),
    ``device`` this process's card (or the ``cpu``), ``slices`` the ranks
    by host of a hybrid mesh. ``axis_ranks`` and ``groups`` give the
    same for every axis (an axis of size 1 has its one rank and no
    group); ``world_group`` is the group of every rank of the mesh
    (``None`` for a mesh of one process).
    """

    axis_sizes: Dict[str, int]
    ranks: Tuple[int, ...]
    group: Optional[tdist.ProcessGroup]
    device: torch.device
    slices: Tuple[Tuple[int, ...], ...] = ()
    axis_ranks: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)
    groups: Dict[str, Optional[tdist.ProcessGroup]] = dataclasses.field(
        default_factory=dict)
    world_group: Optional[tdist.ProcessGroup] = None

    def __deepcopy__(self, memo):
        # The processes and their groups: a model's copy shares them.
        return self

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, in canonical order (a JAX ``mesh.shape``)."""
        return dict(self.axis_sizes)

    def shape_only(self) -> "Mesh":
        """This mesh's axis sizes over this process alone, with no group:
        a pipeline model built on it holds every stage (the one-process
        oracle of a run on this mesh)."""
        return Mesh(dict(self.axis_sizes), (dist.process_index(),), None,
                    self.device)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's position along the data axis."""
        return self.ranks.index(dist.process_index())

    def axis_group(self, axis: str) -> Optional[tdist.ProcessGroup]:
        """The process group along ``axis`` through this process (``None``
        for an axis of one member)."""
        if axis == DATA_AXIS:
            return self.group
        return self.groups.get(axis)

    def axis_index(self, axis: str) -> int:
        """This process's position along ``axis``."""
        if axis == DATA_AXIS:
            return self.index
        ranks = self.axis_ranks.get(axis)
        return ranks.index(dist.process_index()) if ranks else 0

    @property
    def batch_group(self) -> Optional[tdist.ProcessGroup]:
        """The processes of one batch: the ``data`` and ``seq`` axes
        together (the ``data`` axis's group when ``seq`` is 1)."""
        if self.axis_sizes.get(SEQ_AXIS, 1) == 1:
            return self.group
        return self.groups.get(BATCH_PLANE)

    @property
    def model_group(self) -> Optional[tdist.ProcessGroup]:
        """The ``model`` (tensor-parallel) axis's group."""
        return self.axis_group(MODEL_AXIS)

    @property
    def expert_group(self) -> Optional[tdist.ProcessGroup]:
        """The ``expert`` axis's group."""
        return self.axis_group(EXPERT_AXIS)


def _host_ranks() -> Tuple[int, ...]:
    per_host = dist.local_size()
    first = dist.process_index() // per_host * per_host
    return tuple(range(first, first + per_host))


def _data_group(ranks: Tuple[int, ...]) -> Optional[tdist.ProcessGroup]:
    """The process group over ``ranks``: the default group when they are
    the whole job, else this host's share of :func:`tdist.new_subgroups`
    (a collective call: every process of the job builds its host's mesh
    together)."""
    if not tdist.is_initialized():
        if len(ranks) > 1:
            raise RuntimeError(
                f"a mesh of {len(ranks)} processes needs a process group: "
                "call pddl_tpu_torch.core.dist.initialize first")
        return None
    if len(ranks) == tdist.get_world_size():
        return tdist.group.WORLD
    group, _ = tdist.new_subgroups(group_size=len(ranks))
    return group


def build_mesh(
    config: MeshConfig | None = None,
    *,
    ranks: Sequence[int] | None = None,
    group: Optional[tdist.ProcessGroup] = None,
    device=None,
    **axis_sizes: int,
) -> Mesh:
    """Build a :class:`Mesh` from a :class:`MeshConfig`.

    ``build_mesh()`` with no arguments gives the data-parallel mesh over
    every process of the job (this host's with ``local_only``): the
    analogue of constructing a ``MirroredStrategy`` /
    ``MultiWorkerMirroredStrategy`` in the reference. ``ranks`` (with their
    ``group`` when there are several) builds a mesh over a chosen set;
    ``device`` defaults to ``cuda:{local_rank}``.

    Axis sizes can also be passed directly: ``build_mesh(data=4)``.
    """
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")

    if ranks is None:
        ranks = (_host_ranks() if config.local_only
                 else tuple(range(dist.process_count())))
        sizes = config.axis_sizes(len(ranks))
        if _beyond_data(sizes):
            hosts = ([tuple(range(h, h + len(ranks)))
                      for h in range(0, dist.process_count(), len(ranks))]
                     if config.local_only else [ranks])
            return _axes_mesh(sizes, hosts, ranks, device)
        group = _data_group(ranks)
    ranks = tuple(ranks)
    sizes = config.axis_sizes(len(ranks))
    if _beyond_data(sizes):
        if group is not None:
            raise ValueError(
                "a mesh with axes beyond data builds its groups: pass no "
                "group")
        if dist.process_index() not in ranks:
            raise ValueError(f"this process ({dist.process_index()}) is "
                             f"not one of the mesh's ranks {ranks}")
        if list(ranks) != sorted(ranks):
            raise ValueError(
                f"ranks {ranks} of a mesh with axes beyond data must be in "
                "increasing order: a process group orders its members by "
                "rank")
        return _axes_mesh(sizes, [ranks], ranks, device, members_only=True)
    if group is None and len(ranks) > 1:
        raise ValueError(f"a mesh over ranks {ranks} needs their group")
    device = resolve_device(dist.default_device() if device is None
                            else device)
    return Mesh({a: sizes[a] for a in CANONICAL_AXES}, ranks, group, device,
                axis_ranks={a: (dist.process_index(),)
                            for a in CANONICAL_AXES if a != DATA_AXIS},
                world_group=group)


def _beyond_data(sizes: Dict[str, int]) -> bool:
    return any(sizes[a] > 1 for a in CANONICAL_AXES if a != DATA_AXIS)


def axis_coords(sizes: Dict[str, int], rank: int) -> Dict[str, int]:
    """A rank's coordinates on the mesh: JAX's row-major device order,
    the last canonical axis varying fastest."""
    coords = {}
    for axis in reversed(CANONICAL_AXES):
        rank, coords[axis] = divmod(rank, sizes[axis])
    return {a: coords[a] for a in CANONICAL_AXES}


def axis_lines(sizes: Dict[str, int], axis: str,
               ranks: Sequence[int]) -> list:
    """Every line of ranks along ``axis`` (the ranks that differ only in
    their ``axis`` coordinate; ``axis`` may name several, joined by
    ``+``, for a plane), in a fixed order: by the first rank."""
    along = axis.split("+")
    lines: dict = {}
    for pos, rank in enumerate(ranks):
        c = axis_coords(sizes, pos)
        key = tuple(c[a] for a in CANONICAL_AXES if a not in along)
        lines.setdefault(key, []).append(rank)
    return sorted((tuple(v) for v in lines.values()), key=lambda t: t[0])


# Groups made over chosen ranks by their members, by rank tuple: a
# member-synchronised group is named by its ranks, so a later mesh over
# the same ranks takes the group made first.
_MEMBER_GROUPS: Dict[Tuple[int, ...], tdist.ProcessGroup] = {}


def _member_group(line: Tuple[int, ...]) -> tdist.ProcessGroup:
    group = _MEMBER_GROUPS.get(line)
    if group is None:
        group = _MEMBER_GROUPS[line] = tdist.new_group(
            list(line), use_local_synchronization=True)
    return group


def _axes_mesh(sizes: Dict[str, int], meshes: Sequence[Tuple[int, ...]],
               ranks: Tuple[int, ...], device, *,
               members_only: bool = False) -> Mesh:
    """The mesh over ``ranks`` with axes beyond ``data``: one group per
    line of each axis above size 1. Every process makes the groups of
    every mesh of ``meshes`` (``ranks`` among them) in the same order
    (``new_group`` is collective), or with ``members_only`` the groups
    of its own lines only."""
    if not tdist.is_initialized():
        raise RuntimeError(
            f"a mesh of {len(ranks)} processes needs a process group: "
            "call pddl_tpu_torch.core.dist.initialize first")
    me = dist.process_index()
    axis_ranks: Dict[str, Tuple[int, ...]] = {}
    groups: Dict[str, Optional[tdist.ProcessGroup]] = {}
    planes = (BATCH_PLANE,) if sizes[SEQ_AXIS] > 1 else ()
    for mesh_ranks in meshes:
        made: Dict[Tuple[int, ...], tdist.ProcessGroup] = {}
        for axis in CANONICAL_AXES + planes + ("world",):
            lines = ([tuple(mesh_ranks)] if axis == "world"
                     else axis_lines(sizes, axis, mesh_ranks))
            for line in lines:
                group = None
                if len(line) > 1 and (not members_only or me in line):
                    if line not in made:
                        made[line] = (
                            _member_group(line) if members_only
                            else tdist.group.WORLD if axis == "world"
                            and len(line) == tdist.get_world_size()
                            else tdist.new_group(list(line)))
                    group = made[line]
                if me in line:
                    axis_ranks[axis], groups[axis] = line, group
    device = resolve_device(dist.default_device() if device is None
                            else device)
    data = axis_ranks.pop(DATA_AXIS)
    axis_ranks.pop("world")
    world_group = groups.pop("world")
    return Mesh({a: sizes[a] for a in CANONICAL_AXES}, data,
                groups.pop(DATA_AXIS), device, axis_ranks=axis_ranks,
                groups=groups, world_group=world_group)


def slice_groups(
    ranks: Sequence[int],
    num_slices: int | None = None,
) -> list[list[int]]:
    """Group ranks by host (the ICI domain's counterpart: NVLink inside a
    host, the network between hosts).

    A rank's host is ``rank // local_size()``; if every rank is on one
    host, ``num_slices`` splits the list evenly (how tests fake a
    multi-host topology on one machine).
    """
    ranks = list(ranks)
    per_host = dist.local_size()
    if len({r // per_host for r in ranks}) > 1:
        groups: dict = {}
        for r in ranks:
            groups.setdefault(r // per_host, []).append(r)
        out = [groups[k] for k in sorted(groups)]
    else:
        if not num_slices:
            return [ranks]
        if len(ranks) % num_slices != 0:
            raise ValueError(
                f"{len(ranks)} devices not divisible into {num_slices} slices"
            )
        per = len(ranks) // num_slices
        return [ranks[i * per:(i + 1) * per] for i in range(num_slices)]
    if num_slices and len(out) != num_slices:
        raise ValueError(
            f"detected {len(out)} slices but num_slices={num_slices}"
        )
    if len({len(g) for g in out}) != 1:
        raise ValueError(
            f"uneven slices: {[len(g) for g in out]} devices per slice"
        )
    return out


def build_hybrid_mesh(
    config: MeshConfig | None = None,
    *,
    dcn_axis: str = DATA_AXIS,
    num_slices: int | None = None,
    device=None,
    **axis_sizes: int,
) -> Mesh:
    """A multi-host mesh whose data axis is host-major: all of host 0's
    ranks, then host 1's, … — the placement of
    :func:`pddl_tpu.core.mesh.build_hybrid_mesh`, whose gradient all-reduce
    lowers to a reduce inside each host, then one between hosts (NCCL
    builds that hierarchy itself over a host-major ring). Ranks are
    numbered host-major, so the order is the ranks'. ``slices`` records
    the ranks by host.
    """
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis sizes, not both")
    if dcn_axis not in CANONICAL_AXES:
        raise ValueError(f"unknown dcn_axis {dcn_axis!r}")
    mesh = build_mesh(config, device=device)
    groups = slice_groups(mesh.ranks, num_slices)
    n_slices = len(groups)
    if n_slices == 1:
        return mesh
    sizes = mesh.axis_sizes
    if sizes[dcn_axis] % n_slices != 0:
        raise ValueError(
            f"{dcn_axis}-axis size {sizes[dcn_axis]} not divisible by "
            f"{n_slices} slices"
        )
    per_slice = dict(sizes)
    per_slice[dcn_axis] = sizes[dcn_axis] // n_slices
    per_slice_devices = math.prod(per_slice.values())
    if per_slice_devices != len(groups[0]):
        raise ValueError(
            f"per-slice mesh {per_slice} needs {per_slice_devices} devices "
            f"but each slice has {len(groups[0])} — non-DCN axes must fit "
            "inside one slice"
        )
    order = tuple(r for g in groups for r in g)
    return dataclasses.replace(mesh, ranks=order,
                               slices=tuple(tuple(g) for g in groups))


def mesh_num_replicas(mesh: Mesh, axis: str = DATA_AXIS) -> int:
    """Replica count along a mesh axis — the ``strategy.num_replicas_in_sync``
    analogue (reference scales batch by it: ``imagenet-resnet50-mirror.py:54``).
    """
    return mesh.shape[axis]


def validate_divisible(batch_size: int, mesh: Mesh, axis: str = DATA_AXIS) -> None:
    n = mesh_num_replicas(mesh, axis)
    if batch_size % n != 0:
        raise ValueError(
            f"global batch {batch_size} not divisible by {axis}-axis size {n}"
        )


def describe(mesh: Mesh) -> str:
    """Human-readable one-liner for logs."""
    axes = ", ".join(f"{a}={s}" for a, s in mesh.shape.items() if s > 1) or "1 device"
    return f"Mesh({axes}) on {mesh.size} {mesh.device.type} device(s)"
