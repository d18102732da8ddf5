"""Device meshes over ranks — counterpart of
``tensorflowonspark_tpu/parallel/mesh.py``.

Axis names (the vocabulary every sharding rule uses):

- ``dp``   — data parallel: the batch is split, gradients all-reduced;
- ``fsdp`` — data parallel with the parameters and optimizer state
             sharded (ZeRO-3): the batch is split as for dp;
- ``pp``   — pipeline parallel: layers split into stages;
- ``tp``   — tensor parallel: weight matrices split.

Where the JAX mesh is one process over many devices, a mesh here is ONE
RANK PER GPU over the ``torch.distributed`` default group that
``NodeContext.init_distributed`` made: ranks are laid out row-major over
``(dp, fsdp, pp, tp)``, and each axis (and the batch axes together) gets
a process group of its own.  With no process group, or a world of 1, the
mesh has size 1 and every collective short-circuits.  The port never
starts a process group of its own.

On a ``tp`` axis parameters are split Megatron-style and the model's
forward runs its collectives itself (``models.transformer``); a ``pp``
axis holds one pipeline stage a rank (``models.pipelined``).  The model
finds the mesh it runs on through :func:`use_mesh`, the counterpart of
JAX's ambient mesh: the train and eval steps enter it around the
forward.
"""
import contextlib
import dataclasses
import logging
import math
import socket
from typing import Any, NamedTuple

from tensorflowonspark_tpu_torch.feed import _leaves, _map_batch

logger = logging.getLogger(__name__)

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_PP = "pp"
AXIS_TP = "tp"
ALL_AXES = (AXIS_DP, AXIS_FSDP, AXIS_PP, AXIS_TP)

# Axes over which a data batch is split (per-rank feeds, gradient mean).
BATCH_AXES = (AXIS_DP, AXIS_FSDP)

A3C = "ROADMAP A3c"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout.  -1 for dp means "whatever is left"."""
    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    tp: int = 1

    def resolve(self, num_devices):
        fixed = self.fsdp * self.pp * self.tp
        if self.dp == -1:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fsdp*pp*tp={fixed}")
            dp = num_devices // fixed
        else:
            dp = self.dp
        total = dp * fixed
        if total != num_devices:
            raise ValueError(
                f"mesh {dp}x{self.fsdp}x{self.pp}x{self.tp}={total} does not "
                f"match {num_devices} devices")
        return MeshSpec(dp=dp, fsdp=self.fsdp, pp=self.pp, tp=self.tp)

    @property
    def shape(self):
        return (self.dp, self.fsdp, self.pp, self.tp)

    @property
    def batch_size_divisor(self):
        return self.dp * self.fsdp


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _world():
    """``(world size, rank)`` of the default process group, ``(1, 0)``
    without one."""
    dist = _dist()
    return (dist.get_world_size(), dist.get_rank()) if dist else (1, 0)


class _Group(NamedTuple):
    """One process group along some axes: ``pg`` (None: a group of one),
    its size, and ``order[g]``, the axis index of the group's rank ``g``
    (``new_group`` numbers a group's ranks in ascending global rank)."""
    pg: Any
    size: int
    order: tuple


class Mesh:
    """Ranks laid out over ``ALL_AXES``.

    ``shape`` maps each axis to its extent (as ``jax.sharding.Mesh.shape``
    does), ``devices`` is the array of global ranks in that shape, and
    ``coords`` this rank's index along each axis.  ``device`` is where
    this rank's tensors live.  A mesh made directly from a spec, without
    ranks (``Mesh(spec)``), is abstract: its shardings can be computed,
    but nothing can be placed on it when its size is above 1."""

    axis_names = ALL_AXES

    def __init__(self, spec, ranks=None, rank=0, device=None):
        import numpy as np

        self.shape = dict(zip(ALL_AXES, spec.shape))
        self.size = math.prod(spec.shape)
        self.rank = rank
        self.abstract = ranks is None
        ranks = range(self.size) if ranks is None else ranks
        self.devices = np.asarray(list(ranks)).reshape(spec.shape)
        where = np.argwhere(self.devices == rank)
        pos = where[0] if len(where) else (0,) * len(ALL_AXES)
        self.coords = dict(zip(ALL_AXES, (int(i) for i in pos)))
        self.device = device
        self._groups = {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def extent(self, axes):
        """Product of the extents of ``axes`` (a name or a tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes):
        """This rank's row-major index over ``axes``: for the batch axes,
        the block of rows it holds under :func:`batch_sharding`."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The :class:`_Group` of this rank along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups.get(axes) or _Group(None, 1, (0,))

    def neighbor(self, axis, shift):
        """The global rank ``shift`` steps along ``axis`` from this rank
        (cyclic), the other coordinates kept."""
        pos = [self.coords[a] for a in ALL_AXES]
        i = ALL_AXES.index(axis)
        pos[i] = (pos[i] + shift) % self.shape[axis]
        return int(self.devices[tuple(pos)])

    def check_placeable(self):
        """Raise unless tensors can be placed on this mesh: an abstract
        mesh holds no ranks."""
        if self.abstract and self.size > 1:
            raise ValueError(f"{self!r} is abstract (built from a spec, no "
                             "ranks): build it with build_mesh to place "
                             "tensors")

    def _make_groups(self):
        """One process group per axis and one over the batch axes.  Every
        rank calls ``new_group`` for every group of more than one rank,
        in one order (``new_group`` is collective over the world); a
        group that is the whole world is the default group."""
        dist = _dist()
        world = self.size
        made = {}
        for axes in [(a,) for a in ALL_AXES] + [BATCH_AXES]:
            idx = [ALL_AXES.index(a) for a in axes]
            rest = [i for i in range(len(ALL_AXES)) if i not in idx]
            n = math.prod(self.devices.shape[i] for i in idx)
            if n == 1:
                continue
            rows = self.devices.transpose(rest + idx).reshape(-1, n)
            for row in rows:
                members = tuple(sorted(int(r) for r in row))
                if members not in made:
                    made[members] = (dist.group.WORLD if n == world
                                     else dist.new_group(list(members)))
                if self.rank in members:
                    order = tuple(list(row).index(r) for r in members)
                    self._groups[axes] = _Group(made[members], n, order)


def check_serving_mesh(mesh):
    """Raise unless ``mesh`` serves: ``MeshSpec(tp=n)``, every other axis
    of extent 1 (the JAX package serves rows over a dp axis; here
    replicas behind the fleet gateway serve more rows).  Returns the
    mesh's tp extent (1 without a mesh)."""
    if mesh is None:
        return 1
    if mesh.shape[AXIS_DP] > 1:
        raise NotImplementedError(
            f"a dp axis under a serving mesh ({mesh!r}) is not ported yet "
            f"({A3C}); serve more rows with replicas behind the fleet "
            "gateway")
    for axis in (AXIS_FSDP, AXIS_PP):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f"a {axis} axis under a serving mesh ({mesh!r}) is not "
                f"ported yet ({A3C}); a serving mesh is MeshSpec(tp=n)")
    return mesh.shape[AXIS_TP]


def tp_leader(mesh):
    """The global rank of this rank's tp group leader (tp index 0): the
    rank that schedules a tp serving engine (the others follow it)."""
    return mesh.neighbor(AXIS_TP, -mesh.coords[AXIS_TP])


def build_mesh(spec=None, ranks=None, device=None):
    """The mesh of ``spec`` (default ``MeshSpec()``: every rank on dp)
    over ``ranks`` (default: the default group's ranks in order; any
    order of them), one rank per GPU.  ``device`` is where this rank's
    tensors live (``cuda`` unless the caller asks for the CPU, as the
    CPU tests do under gloo)."""
    from tensorflowonspark_tpu_torch.device import resolve

    world, rank = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"ranks {ranks} are not an order of the world's "
                         f"{world} ranks")
    spec = (spec or MeshSpec()).resolve(len(ranks))
    mesh = Mesh(spec, ranks, rank, resolve(device))
    if world > 1:
        mesh._make_groups()
    logger.info("built mesh %s over %d ranks", mesh.shape, world)
    return mesh


class RankDevice(NamedTuple):
    """A rank as a mesh device: its host and the host's index among the
    world's hosts in sorted order (the counterpart of a TPU slice)."""
    rank: int
    host: str
    slice_index: int


def rank_devices():
    """Every rank of the world as a :class:`RankDevice`; the host names
    are gathered once over the default group."""
    dist = _dist()
    host = socket.gethostname()
    hosts = [host]
    if dist is not None and dist.get_world_size() > 1:
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, host)
    index = {h: i for i, h in enumerate(sorted(set(hosts)))}
    return [RankDevice(r, h, index[h]) for r, h in enumerate(hosts)]


def detect_num_slices(devices):
    """Number of distinct slices (hosts) in ``devices`` (1 when they carry
    no ``slice_index``)."""
    return len({getattr(d, "slice_index", 0) for d in devices})


def hybrid_device_array(spec, devices, num_slices):
    """Arrange ``devices`` into a (dp, fsdp, pp, tp) array where the slice
    (host) index varies only along the OUTERMOST part of dp.

    dp is factored as (num_slices, dp_inner): the data-parallel gradient
    all-reduce is the only collective that crosses hosts (the network);
    fsdp, pp, tp and dp_inner stay inside a host (NVLink).  Devices are
    grouped by ``slice_index`` when they all carry one, else by
    contiguous equal partitions of the given order.  A request that
    cannot factor raises ValueError."""
    import numpy as np

    if spec.dp % num_slices != 0:
        raise ValueError(
            f"dp={spec.dp} must be divisible by num_slices={num_slices} "
            "(the dp axis is the only one that crosses hosts)")
    per_slice = len(devices) // num_slices
    if per_slice * num_slices != len(devices):
        raise ValueError(f"{len(devices)} devices not divisible into "
                         f"{num_slices} slices")
    dp_inner = spec.dp // num_slices
    groups = {}
    if all(hasattr(d, "slice_index") for d in devices):
        for d in devices:
            groups.setdefault(d.slice_index, []).append(d)
        if len(groups) != num_slices:
            raise ValueError(
                f"devices span {len(groups)} slices, expected {num_slices}")
    else:
        for i in range(num_slices):
            groups[i] = list(devices[i * per_slice:(i + 1) * per_slice])
    slice_arrays = []
    for key in sorted(groups):
        grp = groups[key]
        if len(grp) != per_slice:
            raise ValueError(f"slice {key} has {len(grp)} devices, "
                             f"expected {per_slice}")
        arr = np.empty(len(grp), dtype=object)
        arr[:] = grp
        slice_arrays.append(arr.reshape((dp_inner, spec.fsdp, spec.pp,
                                         spec.tp)))
    return np.concatenate(slice_arrays, axis=0)


def build_hybrid_mesh(spec=None, num_slices="auto", device=None):
    """A multi-host mesh: the outer factor of dp spans hosts, while fsdp,
    pp, tp and the inner dp factor stay inside a host.

    ``num_slices="auto"`` groups the ranks by host name (gathered once
    over the default group); an explicit ``num_slices`` groups them in
    contiguous equal runs of rank order, as the JAX package does on
    devices without ``slice_index``.  One slice is a plain
    :func:`build_mesh`.  A request that cannot factor over the slices
    raises ValueError."""
    devs = rank_devices()
    spec = (spec or MeshSpec()).resolve(len(devs))
    if num_slices == "auto":
        num_slices = detect_num_slices(devs)
    else:
        devs = [d.rank for d in devs]
    if num_slices == 1:
        return build_mesh(spec, device=device)
    arr = hybrid_device_array(spec, devs, num_slices)
    ranks = [getattr(d, "rank", d) for d in arr.reshape(-1)]
    logger.info("hybrid mesh over %d slices", num_slices)
    return build_mesh(spec, ranks=ranks, device=device)


def local_mesh_spec(num_devices=None, tp=1, pp=1, fsdp=1):
    """Convenience: all remaining ranks to dp."""
    n = num_devices or _world()[0]
    return MeshSpec(dp=-1, fsdp=fsdp, pp=pp, tp=tp).resolve(n)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a tensor lies over a mesh: ``spec`` is the JAX
    ``PartitionSpec`` as a tuple (one entry per dim, in the JAX package's
    dim order: an axis name, a tuple of them, or None; trailing Nones
    dropped).  ``transposed``: the port stores the tensor transposed (a
    ``Dense`` weight is ``[out, in]`` where flax keeps ``[in, out]``), so
    ``spec`` reads the tensor's dims in reverse."""
    mesh: Any
    spec: tuple = ()
    transposed: bool = False

    def dim_axes(self, ndim):
        """Per dim of the tensor as the port stores it, the mesh axes of
        extent above 1 that split it."""
        entries = list(self.spec) + [None] * (ndim - len(self.spec))
        if self.transposed:
            entries = entries[::-1]
        out = []
        for e in entries:
            names = () if e is None else e if isinstance(e, tuple) else (e,)
            out.append(tuple(a for a in names
                             if self.mesh.shape.get(a, 1) > 1))
        return out

    def shard_dim(self, ndim):
        """``[(dim, axes), ...]`` of the dims split over the mesh, in dim
        order (empty for a replicated tensor): fsdp and tp splits, one
        dim each or two (JAX's ``_add_fsdp`` puts fsdp on a dim that tp
        left whole).  A spec over dp (the JAX package's expert rule:
        experts over ep, which rides dp) waits for expert parallelism
        (A3c); one over pp, for a stage layout the port keeps as a module
        a rank (``models.pipelined``)."""
        split = [(d, axes) for d, axes in enumerate(self.dim_axes(ndim))
                 if axes]
        for _, axes in split:
            for a in axes:
                if a == AXIS_PP:
                    raise NotImplementedError(
                        f"a pp-sharded tensor (spec {self.spec}): the port "
                        "holds a pipeline stage as its own module "
                        f"(models.pipelined), not as a split ({A3C})")
                if a not in (AXIS_FSDP, AXIS_TP):
                    raise NotImplementedError(
                        f"a {a}-sharded parameter (spec {self.spec}; MoE "
                        "experts over ep) is not ported yet (ROADMAP A3c: "
                        "expert parallelism)")
        return split

    def split_axes(self, ndim):
        """The mesh axes (of extent above 1) that split the tensor."""
        return tuple(a for _, axes in self.shard_dim(ndim) for a in axes)


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the enclosed forward on ``mesh``: the model's layers read it
    (:func:`active_mesh`) for their process groups, as the JAX model
    reads its ambient mesh.  The train and eval steps enter it."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


# a stack shared by the process's threads: the backward (where remat
# recomputes a block's forward) may run on the autograd engine's thread
_ACTIVE = []


def active_mesh():
    """The innermost :func:`use_mesh` mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def batch_sharding(mesh, seq_axis=None):
    """The sharding of a ``[batch, ...]`` input: the batch split over the
    mesh's batch axes, row block ``dp_index * fsdp + fsdp_index`` to each
    rank (JAX ``P(("dp", "fsdp"))``).  With ``seq_axis`` (context
    parallelism) a ``[batch, seq, ...]`` input is also split over that
    axis along dim 1 (JAX ``P(("dp", "fsdp"), "tp")``).  Ranks that differ
    only along other axes (tp, pp) hold the same block."""
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    if seq_axis is not None:
        if seq_axis in BATCH_AXES or seq_axis not in mesh.axis_names:
            raise ValueError(f"seq_axis={seq_axis!r} must be a mesh axis "
                             "outside the batch axes")
        return NamedSharding(mesh, (axes or None, seq_axis))
    return NamedSharding(mesh, (axes,) if axes else ())


def replicated_sharding(mesh):
    return NamedSharding(mesh, ())


def sharding_mesh(sharding):
    """The mesh of a sharding, or of the first of a batch of them."""
    first = sharding if isinstance(sharding, NamedSharding) else next(
        s for s in _leaves(sharding) if isinstance(s, NamedSharding))
    return first.mesh


def local_shapes(tree):
    """The shapes of a batch's arrays, in leaf order."""
    return [tuple(getattr(x, "shape", ())) for x in _leaves(tree)]


def check_local_batch(tree, sharding):
    """Check the multi-process contract of ``put_batch``: every rank of
    the mesh passes the same local shapes (JAX's
    ``make_array_from_process_local_data``).  One ``all_gather_object``
    over the mesh's ranks when it holds more than one (under nccl its
    readback waits for the device work queued before it); a difference
    raises ValueError naming each rank's shapes."""
    mesh = sharding_mesh(sharding)
    mesh.check_placeable()
    if mesh.size == 1 or _dist() is None:
        return
    import torch.distributed as dist

    shapes = local_shapes(tree)
    got = [None] * mesh.size
    dist.all_gather_object(got, shapes)
    if any(s != shapes for s in got):
        raise ValueError(
            f"every rank must pass the same local batch shapes; by rank: "
            f"{got}")


def put_batch(tree, sharding, device=None):
    """Place a rank-local batch (numpy arrays or tensors: one, or a
    tuple, list or dict of them) on this rank's device, as tensors.

    Each rank passes ITS block (the one :func:`local_rows` picks from a
    global batch: its rows, and under a ``seq_axis`` sharding its
    sequence block of them) and gets it back on its device: the global
    batch of the JAX package's ``put_batch`` is the concatenation of the
    ranks' blocks in batch-index order.  Every rank must pass the same
    local shapes; pad a ragged tail (``feed.pad_batch``).  Checked at
    every call (:func:`check_local_batch`, a collective that waits for
    the queued device work under nccl); ``feed.device_prefetch(
    sharding=)`` checks a stream's first batch only.  A host array is
    copied from pinned memory without blocking."""
    import numpy as np
    import torch

    check_local_batch(tree, sharding)
    dev = device if device is not None else sharding_mesh(sharding).device
    dev = torch.device(dev)

    def put(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda" and a.device.type == "cpu":
            return a.pin_memory().to(dev, non_blocking=True)
        return a.to(dev)

    return _map_batch(put, tree)


def local_rows(tree, mesh, seq_axis=None):
    """This rank's block of a global batch under :func:`batch_sharding`:
    row block ``dp_index * fsdp + fsdp_index`` of ``B / (dp * fsdp)``
    rows, from every array of the tree; with ``seq_axis``, of those rows
    the sequence block (dim 1) at this rank's index along that axis."""
    n = mesh.extent(BATCH_AXES)
    i = mesh.index(BATCH_AXES)

    def rows(a):
        if a.shape[0] % n:
            raise ValueError(f"batch of {a.shape[0]} rows does not split "
                             f"over {n} ranks")
        b = a.shape[0] // n
        return a[i * b:(i + 1) * b]

    out = _map_batch(rows, tree)
    if seq_axis is not None:
        out = seq_block(out, batch_sharding(mesh, seq_axis))
    return out


def seq_block(tree, sharding):
    """This rank's sequence block (dim 1) of every array of a batch of its
    rows under a ``seq_axis`` sharding; the batch itself without one."""
    axis = sharding.spec[1] if len(sharding.spec) > 1 else None
    if axis is None:
        return tree
    mesh = sharding_mesh(sharding)
    n, i = mesh.shape[axis], mesh.coords[axis]

    def block(a):
        if a.ndim < 2 or a.shape[1] % n:
            raise ValueError(
                f"sequence of {tuple(a.shape)[1:2]} must be divisible by "
                f"the {axis!r} axis size {n}")
        s = a.shape[1] // n
        return a[:, i * s:(i + 1) * s]

    return _map_batch(block, tree)
