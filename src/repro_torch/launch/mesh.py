"""Data-parallel, LM and serving-replica meshes as ``torch.distributed``
process groups (the JAX package's ``repro/launch/mesh.py``), one process a
rank.

Two-level data-parallel mesh contract (the task-batched meta-training
step, :func:`repro_torch.core.episodic_train.make_batched_meta_train_step`):

* :func:`make_two_level_dp_mesh` ``(dcn, dp)`` lays the ranks out
  process-major, as the JAX package's ``jax.devices()`` are: rank =
  dcn_index * dp + data_index.  ``torchrun`` numbers ranks node-major, so
  a ``dcn`` row is a node and the ``data`` group rides its NVLink.
* The task axis of a batch shards over both axes, in that order; params
  and optimizer state are replicated, except the compressed reduction's
  error-feedback residual ``opt_state['ef']``, of which each rank holds
  its ``dcn`` row (the JAX package's ``P('dcn')`` leaf; a checkpoint holds
  the whole ``(dcn, ...)`` leaf).
* Gradients are averaged first over ``data`` (one all-reduce, fast), then
  once over ``dcn``, exactly or by the int8 error-feedback all-gather
  (:func:`repro_torch.optim.compress.compressed_all_reduce`).  With
  ``accum_steps`` each rank sums its task chunks before the reduction, so
  the collectives a step do not grow with it.
* At ``dcn`` 1 the extra reduction is over a group of one and the step is
  bit-identical to the 1-D :func:`make_dp_mesh` path.  The collectives a
  step makes and the payload it hands each are counted by
  :mod:`repro_torch.launch.collectives`.

Serving replicas (:func:`make_replica_mesh`, for
:class:`repro_torch.serve.replica.ReplicatedServeEngine`) are a ``(replica,
serve)`` mesh, process-major as above: rank = replica * d + serve index.
A rank's ``serve`` group is its replica group, over which its engine's
serving layout makes its collectives; no collective spans two replica
groups except on the host group.

LM meshes (:func:`make_production_mesh`, :func:`make_test_mesh`) are
``(data, model)`` or ``(pod, data, model)``, rank = (pod * D + data) * M +
model; where both ``pod`` and ``data`` exist the mesh also holds their
joint group, over which FSDP leaves are split (``mesh.group(("pod",
"data"))``), and the joint (data, model) and (pod, data, model) groups.
:meth:`DPMesh.all_gather_tensor` and
:meth:`DPMesh.reduce_scatter_tensor` join and split one tensor along a
dim, and the autograd functions below (:func:`all_gather`,
:func:`reduce_scatter`, :func:`split`, :func:`grad_all_reduce`,
:func:`pmean`) carry them through a backward: the VJP of a
tiled all-gather is a reduce-scatter (or, where every rank of the group
already holds the whole gradient, this rank's slice of it), and the
reverse.  gloo takes ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` on ``cuda`` tensors (checked on torch 2.11 on an
H100, fp32 and bf16), so both backends run the same calls.

Every rank builds every group, in the same order, as ``torch.distributed``
requires.  Each group, and the default one, times out after 60 s, so a
rank that dies ends its peers' waits with an error.  That timeout is why
the groups are made here and not by
``torch.distributed.device_mesh.init_device_mesh``: it gives its groups
the backend's default timeout (30 min on gloo) unless each axis is given
backend options whose timeout is a private field (``_timeout``).  A host group on gloo
over every rank carries the control traffic (barriers, the preemption
verdict, objects) without a device synchronisation.

:func:`init_distributed` makes the default group from ``torchrun``'s
environment: NCCL for a ``cuda`` device, gloo for ``cpu``.  NCCL takes one
rank a card (two ranks on one card fail in NCCL's own init, "Duplicate GPU
detected"); more ranks on a node than it has cards raise before that.
gloo takes ``cuda`` tensors as they are (all-reduce SUM and MIN, the list
all-gather of int8 and fp32: checked on torch 2.11 on an H100), copying
them through host memory itself, so ranks may share a card under gloo; the
wrappers hand it the device tensors.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.collectives import counter

TIMEOUT = datetime.timedelta(seconds=60)
Axes = Union[str, Tuple[str, ...]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _label(axes: Axes) -> str:
    """The counter's name of an axis or of joined axes (``pod+data``)."""
    return "+".join(_axes(axes))


def _world_hint(need: int) -> str:
    return (f"start {need} ranks, one process each: `python -m torch.distributed.run "
            f"--nproc-per-node {need} ...` (torchrun) on the cards, or on the CPU "
            f"`init_distributed('cpu', init_method='file:///<dir>/pg')` in each of "
            f"{need} processes with RANK and WORLD_SIZE set (gloo with a file:// store, "
            f"as the tests run it)")


def world_size() -> int:
    """The world of the default group, or of ``WORLD_SIZE`` before it is made
    (1 where neither is set)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def check_world(need: int, what: str) -> None:
    """Raise unless the world holds exactly ``need`` ranks."""
    have = world_size()
    if have != need:
        raise ValueError(f"{what} = {need} but the world has {have} rank(s); "
                         f"{_world_hint(need)}")


def init_distributed(device, backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Make the default process group from ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (as ``torchrun`` sets them; 0, 1, 0 where unset) and
    return this rank's device.  ``backend`` defaults to NCCL on ``cuda``
    and gloo on ``cpu``; an explicit one is used as given.  NCCL with more
    ranks on this node (``LOCAL_WORLD_SIZE``) than it has cards raises,
    naming the cause; it never turns into gloo.  On ``cuda`` NCCL gives
    rank ``LOCAL_RANK`` the card ``cuda:LOCAL_RANK``; gloo shares the
    cards round-robin.  ``init_method`` defaults to ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``, which torchrun sets)."""
    import torch.distributed as dist
    device = torch.device(device)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r} (want 'nccl' or 'gloo')")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: torch.cuda.is_available() is false; give "
                               "--device cpu to run on gloo without a card")
        cards = torch.cuda.device_count()
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(local + 1)))
        if backend == "nccl" and per_node > cards:
            raise RuntimeError(
                f"NCCL takes one rank a card, but this node runs {per_node} ranks on "
                f"{cards} card(s): start at most {cards} rank(s) a node "
                f"(--nproc-per-node {cards}), or choose gloo (--dist-backend gloo), "
                f"which stages every collective through host memory")
        device = torch.device("cuda", local if backend == "nccl" else local % cards)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("NCCL runs on cuda devices only: give --device cuda, or gloo "
                         "on the CPU")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return device


@dataclasses.dataclass(frozen=True)
class DPMesh:
    """A mesh over the ranks of the default group.

    ``shape`` reads as the JAX mesh's: ``{"data": D}``, ``{"dcn": C,
    "data": D}`` or ``{"replica": R, "serve": d}``; ``coords`` this rank's index along each axis; ``groups``
    one process group per axis, the ranks that share this rank's other
    coordinates; ``host_group`` gloo over every rank."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    coords: Dict[str, int]
    groups: Dict[str, Any]
    host_group: Any
    rank: int
    backend: str

    @property
    def size(self) -> int:
        out = 1
        for n in self.shape.values():
            out *= n
        return out

    def group(self, axes: Axes):
        """The process group of one axis, or of several axes joined (built
        by :func:`_build` for ``("pod", "data")``)."""
        axes = _axes(axes)
        return self.groups[axes[0] if len(axes) == 1 else axes]

    def size_of(self, axes: Axes) -> int:
        """Ranks of the group of ``axes`` (the product of their sizes)."""
        out = 1
        for a in _axes(axes):
            out *= self.shape[a]
        return out

    def index_of(self, axes: Axes) -> int:
        """This rank's index in the group of ``axes``, the first axis
        outermost."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def all_reduce(self, t: torch.Tensor, axis: Axes, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis`` (``sum`` or ``min``) in place;
        returns it."""
        import torch.distributed as dist
        counter.add("all_reduce", _label(axis), t.numel() * t.element_size(),
                    self.size_of(axis))
        rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=rop, group=self.group(axis))
        return t

    def all_gather_tensor(self, t: torch.Tensor, axis: Axes, dim: int = 0) -> torch.Tensor:
        """The group's ``t`` joined along ``dim`` in rank order (a tiled
        all-gather: ``dim`` grows by the group's size); the payload is this
        rank's ``t``."""
        import torch.distributed as dist
        n = self.size_of(axis)
        counter.add("all_gather", _label(axis), t.numel() * t.element_size(), n)
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        # torch 2.13 renames the call ``all_gather_single``; 2.11 has only the old name
        (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(
            out, x, group=self.group(axis))
        return out.movedim(0, dim)

    def reduce_scatter_tensor(self, t: torch.Tensor, axis: Axes, dim: int = 0
                              ) -> torch.Tensor:
        """The group's ``t`` summed, then cut along ``dim`` into equal blocks
        of which this rank keeps its own; the payload is the whole ``t``."""
        import torch.distributed as dist
        n = self.size_of(axis)
        counter.add("reduce_scatter", _label(axis), t.numel() * t.element_size(), n)
        x = t.movedim(dim, 0).contiguous()
        if x.shape[0] % n:
            raise ValueError(f"dim {dim} of size {x.shape[0]} does not split over "
                             f"{_label(axis)!r} of {n} ranks")
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(
            out, x, group=self.group(axis))
        return out.movedim(0, dim)

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axis``, in rank order (list form)."""
        import torch.distributed as dist
        counter.add("all_gather", axis, t.numel() * t.element_size(), self.size_of(axis))
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(out, t, group=self.groups[axis])
        return out

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords``
        replaced (``mesh.rank_at(serve=0)``: this rank's serve-group lead)."""
        where = dict(self.coords, **coords)
        rank = 0
        for axis in self.axis_names:
            rank = rank * self.shape[axis] + where[axis]
        return rank

    def broadcast(self, t: torch.Tensor, axis: str, src: int = 0) -> torch.Tensor:
        """``t`` of the rank at index ``src`` along ``axis``, in place on every
        rank of this rank's ``axis`` group; returns it."""
        import torch.distributed as dist
        counter.add("broadcast", axis, t.numel() * t.element_size(), self.size_of(axis))
        dist.broadcast(t, src=self.rank_at(**{axis: src}), group=self.groups[axis])
        return t

    def barrier(self) -> None:
        import torch.distributed as dist
        counter.add("barrier", "host", 0, self.size)
        dist.barrier(group=self.host_group)

    def any_rank(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (host group)."""
        import torch.distributed as dist
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        counter.add("all_reduce", "host", t.numel() * t.element_size(), self.size)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` on every rank (host group, pickled)."""
        import torch.distributed as dist
        box = [obj]
        counter.add("broadcast", "host", 0, self.size)
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order (host group, pickled)."""
        import torch.distributed as dist
        out = [None] * self.size
        counter.add("all_gather", "host", 0, self.size)
        dist.all_gather_object(out, obj, group=self.host_group)
        return out


def _build(shape: Dict[str, int], axes: Sequence[str]) -> DPMesh:
    """Every rank builds every group of every axis, in one order, then the
    host group; returns this rank's mesh."""
    import torch.distributed as dist
    import numpy as np
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"no process group: call init_distributed first; "
                         f"{_world_hint(int(np.prod([shape[a] for a in axes])))}")
    sizes = [shape[a] for a in axes]
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    rank = dist.get_rank()
    where = [int(i) for i in np.argwhere(grid == rank)[0]]
    groups = {}
    for k, axis in enumerate(axes):
        lines = np.moveaxis(grid, k, -1).reshape(-1, sizes[k])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, timeout=TIMEOUT)
            if rank in ranks:
                groups[axis] = g
    # the joint groups of an LM mesh: (pod, data), the FSDP axes; (data,
    # model) and (pod, data, model), over which a long sequence's cache
    # splits and a pure data-parallel batch runs; each the ranks that share
    # every other coordinate, in the axes' order
    for joint in (("pod", "data"), ("data", "model"), ("pod", "data", "model")):
        if not all(a in axes for a in joint):
            continue
        ks = [axes.index(a) for a in joint]
        if ks != list(range(ks[0], ks[0] + len(ks))):
            raise ValueError(f"axes {axes}: {joint} must come in that order, one after "
                             f"another")
        n = int(np.prod([sizes[k] for k in ks]))
        for line in np.moveaxis(grid, ks, list(range(-len(ks), 0))).reshape(-1, n):
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, timeout=TIMEOUT)
            if rank in ranks:
                groups[joint] = g
    backend = dist.get_backend()
    # gloo cannot run on the store of a ``fake`` world (torch's one-process
    # stand-in for a large world, the dry run's), so there the host group
    # is fake too
    host = dist.new_group(list(range(grid.size)), timeout=TIMEOUT,
                          backend="fake" if backend == "fake" else "gloo")
    return DPMesh(shape=dict(zip(axes, sizes)), axis_names=tuple(axes),
                  coords=dict(zip(axes, where)), groups=groups, host_group=host,
                  rank=rank, backend=backend)


def make_dp_mesh(shards: int, axis: str = "data") -> DPMesh:
    """1-D data-parallel mesh over ``shards`` ranks (the task-batched
    meta-training step shards the task axis over it)."""
    if shards < 1:
        raise ValueError(f"dp_shards must be >= 1, got {shards}")
    check_world(shards, "dp_shards")
    return _build({axis: shards}, (axis,))


def make_two_level_dp_mesh(dcn_shards: int, dp_shards: int, dcn_axis: str = "dcn",
                           axis: str = "data") -> DPMesh:
    """Two-level data-parallel mesh: an outer node-level ``dcn`` axis (the
    slow links: the cross-node gradient reduction) times an inner ``data``
    axis (the node's NVLink); rows of the (dcn, data) grid are nodes under
    torchrun's node-major ranks."""
    if dcn_shards < 1 or dp_shards < 1:
        raise ValueError(f"dcn_shards={dcn_shards}, dp_shards={dp_shards} must be >= 1")
    check_world(dcn_shards * dp_shards,
                f"dcn_shards*dp_shards = {dcn_shards}*{dp_shards}")
    return _build({dcn_axis: dcn_shards, axis: dp_shards}, (dcn_axis, axis))


def make_replica_mesh(replicas: int, devices_per_replica: int,
                      axis: str = "serve") -> DPMesh:
    """The ``(replica, axis)`` mesh of a replicated serving deployment
    (:class:`repro_torch.serve.replica.ReplicatedServeEngine`): ``replicas``
    disjoint groups of ``devices_per_replica`` ranks each, process-major
    (rank = replica * d + index), so that a group is one node's cards under
    torchrun.  This rank's ``axis`` group is its replica group: weights
    placed on it stay there, and every collective its engine's serving
    layout makes runs within it; nothing spans two groups but the host
    group's control traffic.  Weights are replicated per group and the
    task population is partitioned across groups by uid hash."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    if devices_per_replica < 1:
        raise ValueError(f"devices_per_replica must be >= 1, got "
                         f"{devices_per_replica}")
    need = replicas * devices_per_replica
    check_world(need, f"replicas*devices_per_replica = {replicas}*"
                      f"{devices_per_replica}")
    return _build({"replica": replicas, axis: devices_per_replica}, ("replica", axis))


def serve_axis(mesh: DPMesh) -> str:
    """The serving group's axis of a replica mesh: its last, whatever name
    :func:`make_replica_mesh` gave it (``serve`` by default)."""
    return mesh.axis_names[-1]


def make_mesh_for(devices_shape, axes) -> DPMesh:
    """A mesh of any shape over the whole world (the elastic re-mesh)."""
    shape = dict(zip(axes, (int(n) for n in devices_shape)))
    need = 1
    for n in shape.values():
        need *= n
    check_world(need, f"mesh {shape}")
    return _build(shape, tuple(axes))


def make_test_mesh() -> DPMesh:
    """Every rank of the world as a (data, model) = (n, 1) mesh."""
    return make_mesh_for((world_size(), 1), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, pods: int = 2) -> DPMesh:
    """The production LM mesh of the JAX package's launcher: ``(data,
    model)`` 16 x 16 (256 ranks), or ``(pod, data, model)`` ``pods`` x 16 x
    16.  The world must hold exactly that many ranks; otherwise it raises
    with the ``torchrun`` line that starts them."""
    shape = (pods, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    check_world(need, f"the production mesh {dict(zip(axes, shape))}")
    return _build(dict(zip(axes, shape)), axes)


# ---------------------------------------------------------------------------
# the collectives of the sharded LM step, differentiable
# ---------------------------------------------------------------------------

def local_block(t: torch.Tensor, mesh: DPMesh, axes: Axes, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` in the group of ``axes`` (a
    view; ``t`` itself over a group of one)."""
    n = mesh.size_of(axes)
    step = t.shape[dim] // n
    return t.narrow(dim, mesh.index_of(axes) * step, step)


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along ``dim``.  Backward: ``vjp="sum"``, a
    reduce-scatter (each rank of the group used the whole tensor on its own
    data, and the gradients add); ``vjp="slice"``, this rank's block of the
    gradient (every rank of the group computed the same whole gradient)."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim, vjp):
        ctx.args = (mesh, axes, dim, vjp)
        return mesh.all_gather_tensor(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, vjp = ctx.args
        if vjp == "sum":
            return mesh.reduce_scatter_tensor(g, axes, dim), None, None, None, None
        return local_block(g, mesh, axes, dim).contiguous(), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the group, keep this rank's block along ``dim``.  Backward:
    a tiled all-gather."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.reduce_scatter_tensor(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.all_gather_tensor(g, axes, dim), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block of a tensor the group holds whole.  Backward: a
    tiled all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return local_block(t, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.all_gather_tensor(g, axes, dim), None, None, None


class _GradAllReduce(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the group: a
    value every rank holds whole, of which each rank's computation uses a
    part (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce(g.clone(), axes), None, None


class _Mean(torch.autograd.Function):
    """The group's mean.  Backward: the gradient over the group's size
    (every rank gets the same gradient of the mean)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.args = (mesh, axes)
        return mesh.all_reduce(t.clone(), axes) / mesh.size_of(axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return g / mesh.size_of(axes), None, None


def all_gather(t: torch.Tensor, mesh: DPMesh, axes: Axes, dim: int = 0,
               vjp: str = "sum") -> torch.Tensor:
    """:class:`_AllGather`; the identity over a group of one."""
    if vjp not in ("sum", "slice"):
        raise ValueError(f"vjp={vjp!r} (want 'sum' or 'slice')")
    return t if mesh.size_of(axes) == 1 else _AllGather.apply(t, mesh, axes, dim, vjp)


def reduce_scatter(t: torch.Tensor, mesh: DPMesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """:class:`_ReduceScatter`; the identity over a group of one."""
    return t if mesh.size_of(axes) == 1 else _ReduceScatter.apply(t, mesh, axes, dim)


def split(t: torch.Tensor, mesh: DPMesh, axes: Axes, dim: int = 0) -> torch.Tensor:
    """:class:`_Split`; the identity over a group of one."""
    return t if mesh.size_of(axes) == 1 else _Split.apply(t, mesh, axes, dim)


def grad_all_reduce(t: torch.Tensor, mesh: DPMesh, axes: Axes) -> torch.Tensor:
    """:class:`_GradAllReduce`; the identity over a group of one."""
    return t if mesh.size_of(axes) == 1 else _GradAllReduce.apply(t, mesh, axes)


def pmean(t: torch.Tensor, mesh: DPMesh, axes: Axes) -> torch.Tensor:
    """:class:`_Mean`; the identity over a group of one."""
    return t if mesh.size_of(axes) == 1 else _Mean.apply(t, mesh, axes)
