"""The process group, a mesh of ranks over it, and the per-axis
collectives the reference's ``shard_map`` bodies use (the role of
``repro.compat.shard_map``).

The reference runs one process over a mesh of devices and writes the
per-device body once (``shard_map``): ``jax.lax.axis_index``, ``psum``,
``pmax``, ``ppermute`` name a mesh axis. The port runs one process per
device (a *rank*) under ``torch.distributed``, and each rank runs that
body for itself:

* :func:`init_process_group` starts the group from the usual
  environment: ``RANK``, ``WORLD_SIZE`` (``LOCAL_RANK`` and
  ``LOCAL_WORLD_SIZE`` when several hosts share the job), and either a
  ``file://`` store named by ``REPRO_TORCH_DIST_STORE`` (what
  :func:`repro_torch.conformance.subproc.run_ranks` gives each launch) or
  ``MASTER_ADDR``/``MASTER_PORT`` (what ``torchrun`` sets);
  :func:`destroy_process_group` ends it; :func:`process_group` does both
  around a block.
* **Backend.** ``nccl`` when each rank of a host has a card of its own;
  ``gloo`` when the ranks share a card or run on the CPU: NCCL refuses two
  ranks on one GPU ("Duplicate GPU detected"). Under gloo a CUDA tensor's
  payload is copied to host memory, moved, and copied back inside these
  helpers: explicit, counted (:attr:`ProcessMesh.staged_bytes`) and said
  when the group starts. Nothing falls back quietly: the backend is
  chosen from what the job has, and a collective that fails raises.
* :class:`ProcessMesh` lays the ranks over a
  :class:`~repro_torch.launch.mesh.MeshShape` in row-major order (as
  ``jax.make_mesh`` lays devices) with one subgroup per axis and per set
  of axes, and gives :meth:`~ProcessMesh.axis_index`,
  :meth:`~ProcessMesh.axis_size` and the collectives: :meth:`~ProcessMesh.
  psum` (``all_reduce`` SUM), :meth:`~ProcessMesh.pmax` (MAX),
  :meth:`~ProcessMesh.ppermute` (``batch_isend_irecv``; a rank no pair
  sends to gets zeros, as in JAX), :meth:`~ProcessMesh.all_gather` and
  :meth:`~ProcessMesh.reduce_scatter`.
  ``psum`` and ``ppermute`` carry gradients as JAX transposes them: the
  gradient of a psum is a psum, that of a ppermute the inverse
  permutation. Each counts the bytes it moves (:attr:`ProcessMesh.moved`)
  and the host seconds it takes (:attr:`ProcessMesh.seconds`).
* Tensor parallelism's regions (explicit SPMD, where the reference lets
  GSPMD insert the collectives): :meth:`~ProcessMesh.copy_to`
  (Megatron's *f*: identity forward, psum backward),
  :meth:`~ProcessMesh.reduce_from` (*g*: psum forward, identity
  backward) and :meth:`~ProcessMesh.gather_from` (an all-gather whose
  backward takes the rank's block of a whole gradient or reduce-scatters
  partial ones). :class:`TracingMesh` is one rank of a mesh with no
  process group, whose collectives are custom ops, for tracing a rank's
  program (the dry run's multi-card cells).
* :class:`NamedSharding` places a tensor by a spec (one entry per
  dimension: ``None``, an axis name or a tuple of names, as
  :mod:`repro_torch.sharding.rules` gives them): :meth:`~NamedSharding.
  shard` is this rank's block (a view), :meth:`~NamedSharding.gather`
  the whole tensor back, and :meth:`~NamedSharding.shard_shape` equals
  ``jax.sharding.NamedSharding(mesh, spec).shard_shape``. The port slices
  the tensors itself instead of using ``torch.distributed.tensor``: every
  payload must go through the helpers above, which stage it through the
  host under gloo, and the optimizer updates a plain local tensor with no
  per-op dispatch.

A mesh of one device needs no process group: every axis has size 1 and
no collective runs.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import time
from collections import Counter
from datetime import timedelta

import torch
import torch.distributed as dist

from . import resolve_device

#: the environment variable naming a launch's ``file://`` store
STORE_ENV = "REPRO_TORCH_DIST_STORE"


# ------------------------------------------------------------ the group
def choose_backend(device, local_world: int) -> tuple[str, str]:
    """(backend, why) for ``local_world`` ranks of one host on
    ``device``'s kind."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", (f"each of the {local_world} ranks has a card of "
                        f"its own")
    return "gloo", (f"{local_world} ranks share {cards} card(s) and NCCL "
                    f"refuses two ranks on one GPU: every payload is "
                    f"staged through host memory (a copy out, gloo over "
                    f"the host, a copy back)")


def init_process_group(device=None, *, timeout_s: float = 600.0) -> str:
    """Start the process group from the environment (see the module's
    docstring) for ranks on ``device`` (``None``: cuda), each CUDA rank
    on card ``LOCAL_RANK`` modulo the cards there are. Logs the backend
    and why on rank 0; returns the backend."""
    try:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(
            f"{e.args[0]} is not set: start the ranks with `python -m "
            f"repro_torch.distributed --nproc N ...` or torchrun") from None
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    store = os.environ.get(STORE_ENV)
    if not store and not os.environ.get("MASTER_ADDR"):
        raise RuntimeError(f"neither {STORE_ENV} (a file:// store) nor "
                           f"MASTER_ADDR/MASTER_PORT is set")
    dev = resolve_device(device)
    backend, why = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=store or "env://",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"[distributed] {world} ranks, backend {backend}: {why}",
              flush=True)
    return backend


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device=None, *, timeout_s: float = 600.0):
    """:func:`init_process_group` around a block (yields the backend);
    the group is destroyed however the block ends."""
    backend = init_process_group(device, timeout_s=timeout_s)
    try:
        yield backend
    finally:
        destroy_process_group()


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The ranks in the job; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


# ------------------------------------------------------------- the mesh
class ProcessMesh:
    """The job's ranks laid over ``shape`` (a
    :class:`~repro_torch.launch.mesh.MeshShape`) in row-major order.
    ``.shape`` maps each axis to its size, as the sharding rules read a
    mesh. Every rank must build the same meshes in the same order: the
    subgroups are made collectively."""

    def __init__(self, shape, device=None):
        self.mesh_shape = shape
        self.axis_names = tuple(shape.axis_names)
        self.sizes = tuple(int(s) for s in shape.axis_sizes)
        n = math.prod(self.sizes)
        if n != world_size():
            raise ValueError(f"a mesh of {n} devices over {world_size()} "
                             f"ranks")
        self.rank = rank()
        self.coords = dict(zip(self.axis_names, _unravel(self.rank,
                                                         self.sizes)))
        self.device = resolve_device(device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        #: payload bytes this rank gave to each collective, and the bytes
        #: staged through the host (copied out and back) under gloo
        self.moved: Counter = Counter()
        self.staged_bytes = 0
        #: host seconds this rank spent in each collective, staging included
        self.seconds: Counter = Counter()
        self._groups: dict = {}
        self._free: dict = {}       # staged host buffers, by shape, dtype
        for a in self.axis_names:
            self._group((a,))

    @property
    def shape(self) -> dict[str, int]:
        return self.mesh_shape.shape

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def members(self, axes) -> list[int]:
        """The global ranks that share this rank's coordinates off
        ``axes``, in the row-major order of theirs on ``axes``."""
        return list(self._group(axes)[1])

    def reset_moved(self) -> None:
        self.moved.clear()
        self.seconds.clear()
        self.staged_bytes = 0

    # ---------------------------------------------------------- groups
    def _axes(self, axes) -> tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise ValueError(f"no axis {unknown} in mesh {self.shape}")
        return axes

    def _group(self, axes) -> tuple:
        """(group, members): the subgroup of the ranks that share this
        rank's coordinates off ``axes``, and its members' global ranks in
        the row-major order of their coordinates on ``axes``. ``group``
        is None for one member. Made (collectively, on every rank) for
        every such set of ranks the first time ``axes`` is asked for."""
        axes = self._axes(axes)
        if axes not in self._groups:
            others = [a for a in self.axis_names if a not in axes]
            mine = None
            for fixed in itertools.product(
                    *(range(self.shape[a]) for a in others)):
                coords = dict(zip(others, fixed))
                members = []
                for along in itertools.product(
                        *(range(self.shape[a]) for a in axes)):
                    coords.update(zip(axes, along))
                    members.append(_ravel(
                        [coords[a] for a in self.axis_names], self.sizes))
                group = dist.new_group(members) if len(members) > 1 \
                    else None
                if self.rank in members:
                    mine = (group, members)
            self._groups[axes] = mine
        return self._groups[axes]

    def _index(self, axes) -> int:
        """This rank's position along ``axes`` (row-major)."""
        return _ravel([self.coords[a] for a in axes],
                      [self.shape[a] for a in axes])

    # ----------------------------------------------------- transport
    def _host(self, x: torch.Tensor, copy: bool) -> torch.Tensor:
        """The buffer a collective reads (and, with ``copy``, writes): a
        host copy of ``x`` under gloo with CUDA (in a buffer of
        :meth:`_buffer`, which the collective gives back), else ``x``
        contiguous (a copy of it with ``copy``)."""
        if self.staged:
            if x.is_cuda:
                self.staged_bytes += x.numel() * x.element_size()
            return self._buffer(x.shape, x.dtype, x.device).copy_(x)
        return x.clone(memory_format=torch.contiguous_format) if copy \
            else x.contiguous()

    def _buffer(self, shape, dtype, device) -> torch.Tensor:
        """An empty buffer for a payload: under gloo with CUDA a host
        buffer of that shape and dtype that an earlier collective gave
        back (:meth:`_release`), else a new one on ``device``. A step
        stages the same shapes every time, and a new host buffer of
        hundreds of MB costs its page faults again at every step."""
        if not self.staged:
            return torch.empty(shape, dtype=dtype, device=device)
        free = self._free.get((tuple(shape), dtype))
        return free.pop() if free else torch.empty(shape, dtype=dtype)

    def _release(self, *bufs: torch.Tensor) -> None:
        """Give host buffers of :meth:`_buffer` back to it (under gloo
        with CUDA; a no-op otherwise)."""
        for b in bufs:
            if self.staged and b.device.type == "cpu":
                self._free.setdefault((tuple(b.shape), b.dtype),
                                      []).append(b)

    def _back(self, buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """``buf`` on ``like``'s device (the copy back of a staged
        payload); under gloo with CUDA always a copy, since ``buf`` goes
        back to :meth:`_buffer`."""
        if buf.device != like.device:
            self.staged_bytes += buf.numel() * buf.element_size()
            return buf.to(like.device)
        return buf.clone() if self.staged else buf

    def _count(self, name: str, x: torch.Tensor) -> None:
        self.moved[name] += x.numel() * x.element_size()

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """``x`` reduced (``"sum"`` or ``"max"``) over the ranks of
        ``axes``: a new tensor; no gradient."""
        return self.all_reduce_start(x, axes, op).wait()

    def all_reduce_start(self, x: torch.Tensor, axes, op: str = "sum"
                         ) -> "PendingReduce":
        """Start :meth:`all_reduce` of ``x`` and return at once: its
        ``wait()`` gives the result. Under gloo the reduction runs on the
        process group's threads meanwhile, so that reductions started
        one after another overlap each other and the staging copies of
        the next ones."""
        group, _ = self._group(axes)
        x = x.detach()
        if group is None:
            return PendingReduce(self, None, x.clone(), x, "")
        t0 = time.perf_counter()
        name = "psum" if op == "sum" else "pmax"
        self._count(name, x)
        buf = self._host(x, copy=True)
        work = dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                        "max": dist.ReduceOp.MAX}[op],
                               group=group, async_op=True)
        self.seconds[name] += time.perf_counter() - t0
        return PendingReduce(self, work, buf, x, name)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``jax.lax.psum(x, axes)``: the sum over ``axes``, on every
        rank of them; its gradient is the psum of the incoming one."""
        return _PSum.apply(x, self, self._axes(axes))

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``jax.lax.pmax(x, axes)`` (no gradient)."""
        return self.all_reduce(x, axes, "max")

    # ------------------------------------------ tensor-parallel regions
    def copy_to(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Megatron's *f*: ``x`` (the same on every rank of ``axis``)
        entering compute split over ``axis``. Identity forward; backward
        the psum of the ranks' partial gradients."""
        return _CopyTo.apply(x, self, self._axes(axis))

    def reduce_from(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Megatron's *g*: the sum over ``axis`` of the ranks' partial
        ``x``, leaving split compute. psum forward; backward the identity
        (the incoming gradient is the whole one on every rank). Not
        :meth:`psum`, whose backward psums again: used here it would
        multiply every upstream gradient by the axis size."""
        return _ReduceFrom.apply(x, self, self._axes(axis))

    def gather_from(self, x: torch.Tensor, axis: str, dim: int,
                    partial: bool = False) -> torch.Tensor:
        """The ranks' blocks of ``x`` concatenated along ``dim`` over
        ``axis``. Backward: this rank's block of the incoming gradient
        when what reads the result runs the same on every rank (the
        gradient is whole and equal there), or with ``partial`` the
        gradient reduce-scattered (summed over the ranks, each keeping
        its block) when each rank reads only its part of the result."""
        return _GatherFrom.apply(x, self, axis, dim % x.dim(), partial)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``jax.lax.ppermute(x, axis, perm)``: for each ``(src, dst)`` of
        ``perm`` (indices along ``axis``) the rank at ``dst`` receives the
        ``x`` of the rank at ``src``; a rank that receives nothing gets
        zeros. Its gradient moves back along the inverse permutation."""
        return _PPermute.apply(x, self, axis, tuple(map(tuple, perm)))

    def _ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        group, members = self._group(axis)
        x = x.detach()
        me = self.coords[axis]
        sends = [dst for src, dst in perm if src == me]
        recvs = [src for src, dst in perm if dst == me]
        if len(sends) > 1 or len(recvs) > 1:
            raise ValueError(f"perm {perm} is not a permutation")
        out = torch.zeros_like(x)
        if group is None:
            return x.clone() if sends and recvs else out
        t0 = time.perf_counter()
        ops, bufs = [], []
        if sends:
            self._count("ppermute", x)
            bufs.append(self._host(x, copy=False))
            ops.append(dist.P2POp(dist.isend, bufs[-1], members[sends[0]],
                                  group))
        if recvs:
            bufs.append(self._buffer(out.shape, out.dtype, out.device))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], members[recvs[0]],
                                  group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = self._back(bufs[-1], out) if recvs else out
        self._release(*bufs)
        self.seconds["ppermute"] += time.perf_counter() - t0
        return out

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """This rank's block of the sum over ``axis`` of the ranks' ``x``:
        ``x`` cut into equal blocks along ``dim``, the i-th the i-th
        member's (no gradient). Each rank sends every other member its
        block and adds what it receives to its own: a rank moves
        (n-1)/n of ``x``, where an all-reduce moves about twice that."""
        group, members = self._group(axis)
        x = x.detach()
        blocks = x.chunk(len(members), dim)
        me = self.coords[axis]
        if group is None:
            return blocks[0].clone()
        t0 = time.perf_counter()
        ops, sent, got = [], [], []
        for j, m in enumerate(members):
            if j != me:
                sent.append(self._host(blocks[j], copy=False))
                got.append(self._buffer(blocks[me].shape, x.dtype,
                                        x.device))
                self._count("reduce_scatter", blocks[j])
                ops += [dist.P2POp(dist.isend, sent[-1], m, group),
                        dist.P2POp(dist.irecv, got[-1], m, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = blocks[me].clone()
        for b in got:
            out += self._back(b, out)
        self._release(*sent, *got)
        self.seconds["reduce_scatter"] += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks of ``axes``' blocks of ``x`` concatenated along
        ``dim`` in the order of their coordinates on ``axes`` (no
        gradient). One broadcast from each member, which moved the same
        bytes faster than gloo's all_gather on CPU ranks."""
        group, members = self._group(axes)
        x = x.detach()
        if group is None:
            return x.clone()
        t0 = time.perf_counter()
        self._count("all_gather", x)
        buf = self._host(x, copy=False)
        parts = []
        for m in members:
            part = buf if m == self.rank else \
                self._buffer(buf.shape, buf.dtype, buf.device)
            dist.broadcast(part, src=m, group=group)
            parts.append(part)
        whole = list(buf.shape)
        whole[dim] *= len(members)
        cat = torch.cat(parts, dim,
                        out=self._buffer(whole, buf.dtype, buf.device))
        out = self._back(cat, x)
        self._release(*parts, cat)
        self.seconds["all_gather"] += time.perf_counter() - t0
        return out

    def gather(self, x: torch.Tensor, axes, dst: int) -> list | None:
        """The blocks of ``x`` of the ranks of ``axes`` (this rank's
        set), in host memory at global rank ``dst``, in the order of their
        coordinates on ``axes``; None on the other ranks (no gradient)."""
        group, members = self._group(axes)
        x = x.detach()
        if group is None:
            return [x.to("cpu", copy=True)] if self.rank == dst else None
        t0 = time.perf_counter()
        self._count("gather", x)
        buf = self._host(x, copy=False)
        parts = None
        if self.rank == dst:
            parts = [torch.empty(buf.shape, dtype=buf.dtype)
                     for _ in members]
        dist.gather(buf, parts, dst=dst, group=group)
        self._release(buf)
        self.seconds["gather"] += time.perf_counter() - t0
        if parts is None:
            return None
        by_rank = {dist.get_global_rank(group, i): p
                   for i, p in enumerate(parts)}
        return [by_rank[m] for m in members]


class PendingReduce:
    """An all-reduce :meth:`ProcessMesh.all_reduce_start` started."""

    def __init__(self, mesh: ProcessMesh, work, buf: torch.Tensor,
                 like: torch.Tensor, name: str):
        self.mesh, self.work, self.buf, self.like = mesh, work, buf, like
        self.name = name

    def wait(self, part=None) -> torch.Tensor:
        """The result on the input's device; with ``part`` (a function of
        the whole result giving a view of it) only that part is copied
        back from the host."""
        t0 = time.perf_counter()
        if self.work is not None:
            self.work.wait()
        out = self.buf if part is None else part(self.buf)
        if self.mesh.staged:
            out = self.mesh._back(out.contiguous(), self.like)
            self.mesh._release(self.buf)
        if self.name:
            self.mesh.seconds[self.name] += time.perf_counter() - t0
        return out


# ------------------------------------------------------ the tracing mesh
@torch.library.custom_op("repro_torch::all_reduce", mutates_args=())
def _all_reduce_op(x: torch.Tensor, op: str, n: int) -> torch.Tensor:
    return x * n if op == "sum" else x.clone()


@_all_reduce_op.register_fake
def _(x, op, n):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::all_gather", mutates_args=())
def _all_gather_op(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    return torch.cat([x] * n, dim)


@_all_gather_op.register_fake
def _(x, dim, n):
    shape = list(x.shape)
    shape[dim] *= n
    return x.new_empty(shape)


@torch.library.custom_op("repro_torch::reduce_scatter", mutates_args=())
def _reduce_scatter_op(x: torch.Tensor, dim: int, n: int,
                       index: int) -> torch.Tensor:
    return x.chunk(n, dim)[index] * n


@_reduce_scatter_op.register_fake
def _(x, dim, n, index):
    shape = list(x.shape)
    shape[dim] //= n
    return x.new_empty(shape)


class TracingMesh(ProcessMesh):
    """Rank ``rank`` of ``shape`` with no process group, for tracing one
    rank's program (the dry run's multi-card cells): each collective is a
    custom op (``repro_torch::all_reduce``, ``::all_gather``,
    ``::reduce_scatter``; ``core.tracing.COLLECTIVE_OPS``) whose fake
    implementation gives the result's shape, so a trace on fake tensors
    records every collective as a node with its operand. On real tensors
    they compute as if every rank held this rank's tensor. Bytes are
    counted in :attr:`moved` as :class:`ProcessMesh` counts them."""

    def __init__(self, shape, rank: int = 0, device=None):
        self.mesh_shape = shape
        self.axis_names = tuple(shape.axis_names)
        self.sizes = tuple(int(s) for s in shape.axis_sizes)
        self.rank = rank
        self.coords = dict(zip(self.axis_names, _unravel(rank, self.sizes)))
        self.device = resolve_device(device)
        self.backend, self.staged = None, False
        self.moved: Counter = Counter()
        self.staged_bytes = 0
        self.seconds: Counter = Counter()

    def _group(self, axes):
        raise NotImplementedError("a TracingMesh has no process group")

    def _n(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def all_reduce_start(self, x, axes, op: str = "sum") -> PendingReduce:
        n = self._n(axes)
        x = x.detach()
        if n == 1:
            return PendingReduce(self, None, x.clone(), x, "")
        self._count("psum" if op == "sum" else "pmax", x)
        return PendingReduce(self, None,
                             torch.ops.repro_torch.all_reduce(x, op, n), x,
                             "")

    def all_gather(self, x, axes, dim: int = 0):
        n = self._n(axes)
        x = x.detach()
        if n == 1:
            return x.clone()
        self._count("all_gather", x)
        return torch.ops.repro_torch.all_gather(x, dim % x.dim(), n)

    def reduce_scatter(self, x, axis: str, dim: int):
        n = self._n(axis)
        x = x.detach()
        if n == 1:
            return x.clone()
        self.moved["reduce_scatter"] += \
            x.numel() * x.element_size() * (n - 1) // n
        return torch.ops.repro_torch.reduce_scatter(
            x, dim % x.dim(), n, self.coords[axis])


def _unravel(i: int, sizes) -> list[int]:
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return out[::-1]


def _ravel(coords, sizes) -> int:
    i = 0
    for c, s in zip(coords, sizes):
        i = i * s + c
    return i


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_reduce(x, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes, "sum"), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes, "sum"), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, partial):
        ctx.mesh, ctx.axis, ctx.dim, ctx.partial = mesh, axis, dim, partial
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if ctx.partial:
            out = mesh.reduce_scatter(g.contiguous(), axis, dim)
        else:
            n = mesh.axis_size(axis)
            out = g.narrow(dim, mesh.axis_index(axis) * (g.shape[dim] // n),
                           g.shape[dim] // n).contiguous()
        return out, None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return mesh._ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return ctx.mesh._ppermute(g, ctx.axis, inverse), None, None, None


# ------------------------------------------------------------ placement
class NamedSharding:
    """A tensor's placement over ``mesh``: ``spec[i]`` (``None``, an axis
    name or a tuple of names; missing trailing entries are ``None``)
    splits dimension ``i`` into equal blocks over those axes, the first
    name the major one (``jax.sharding.NamedSharding``). ``parts[i]``
    (1 where missing) lays ``parts[i]`` equal parts side by side along
    dimension ``i``, each split over the axes on its own: a rank's block
    is its block of every part, in part order (Mamba's ``w_in``, its two
    halves, :func:`repro_torch.sharding.rules.param_parts`)."""

    def __init__(self, mesh: ProcessMesh, spec, parts=()):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.parts = tuple(parts)

    def __repr__(self) -> str:
        parts = f", parts {self.parts}" if self.parts else ""
        return f"NamedSharding({self.mesh.shape}, {self.spec}{parts})"

    def _entries(self, ndim: int):
        """(dimension, its axes, its parts) of every dimension."""
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-d tensor")
        for i, e in enumerate(self.spec + (None,) * (ndim - len(self.spec))):
            axes = () if e is None else (e,) if isinstance(e, str) \
                else tuple(e)
            yield i, axes, self.parts[i] if i < len(self.parts) else 1

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of each rank's block of a tensor of ``shape``."""
        out = list(shape)
        for i, axes, k in self._entries(len(shape)):
            n = math.prod(self.mesh.shape[a] for a in axes)
            if out[i] % (n * k):
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"split into {k} x {n} blocks ({self})")
            out[i] //= n
        return tuple(out)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``t`` (a view; a copy
        where a dimension has parts)."""
        local = self.shard_shape(t.shape)
        for i, axes, k in self._entries(t.dim()):
            if axes:
                lp = local[i] // k
                t = t.unflatten(i, (k, -1)).narrow(
                    i + 1, self.mesh._index(axes) * lp, lp).flatten(i, i + 1)
        return t

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (``local`` is this
        rank's): all-gathers along each sharded dimension."""
        for i, axes, k in self._entries(local.dim()):
            if axes:
                n = math.prod(self.mesh.shape[a] for a in axes)
                local = self.mesh.all_gather(local, axes, dim=i)
                if k > 1:       # (rank, part, ...) -> (part, rank, ...)
                    local = local.unflatten(i, (n, k, -1)).transpose(
                        i, i + 1).flatten(i, i + 2)
        return local

    def gather_to_rank0(self, local: torch.Tensor) -> torch.Tensor | None:
        """The whole tensor in host memory at rank 0 (a new tensor), from
        the blocks of the ranks that share rank 0's coordinates off the
        sharded axes; None on every other rank (those outside that set
        move nothing)."""
        mesh = self.mesh
        entries = list(self._entries(local.dim()))
        axes = tuple(a for _, ax, _ in entries for a in ax)
        if not axes:
            return local.detach().to("cpu", copy=True) \
                if mesh.rank == 0 else None
        if 0 not in mesh._group(axes)[1]:
            return None
        parts = mesh.gather(local, axes, dst=0)
        if parts is None:
            return None
        whole = torch.empty(tuple(n * math.prod(mesh.shape[a] for a in ax)
                                  for n, (_, ax, _) in zip(local.shape,
                                                           entries)),
                            dtype=local.dtype)
        for m, part in zip(mesh._group(axes)[1], parts):
            coords = dict(zip(mesh.axis_names, _unravel(m, mesh.sizes)))
            block = whole
            # the last dimension first: a split dimension's index does
            # not move when a later one is cut into parts
            for i, ax, k in reversed(entries):
                if ax:
                    j = _ravel([coords[a] for a in ax],
                               [mesh.shape[a] for a in ax])
                    lp = local.shape[i] // k
                    block = block.unflatten(i, (k, -1)).narrow(i + 1, j * lp,
                                                               lp)
                    part = part.unflatten(i, (k, lp))
            block.copy_(part)
        return whole


def shardings(mesh: ProcessMesh, specs, tree, parts=None):
    """A :class:`NamedSharding` for every leaf of ``tree``, from the spec
    tree ``specs`` that mirrors it (:mod:`repro_torch.sharding.rules`);
    ``parts(path, spec, shape)``, where given, is the leaf's parts."""
    from .tree import tree_map_with_path

    def one(path, leaf):
        spec = specs
        for key in path:
            spec = spec[key]
        return NamedSharding(mesh, spec, () if parts is None else
                             parts(path, spec, tuple(leaf.shape)))

    return tree_map_with_path(one, tree)


def main(argv=None) -> int:
    """``python -m repro_torch.distributed --nproc N <python args...>``:
    start N local ranks of ``python <args>`` (each with its rank, the
    world size and a ``file://`` store of its own), wait for all, print
    each rank's output; a rank that fails ends the others and the exit
    code is 1."""
    import argparse
    import sys

    from .conformance.subproc import SubprocessError, run_ranks
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--timeout", type=int, default=3600)
    ours = 0      # the launcher's options come first; the rest is python's
    while ours < len(argv) and argv[ours] in ("--nproc", "--timeout"):
        ours += 2
    a = ap.parse_args(argv[:ours])
    try:
        outs = run_ranks(argv[ours:], a.nproc, timeout=a.timeout)
    except SubprocessError as e:
        print(e, file=sys.stderr)
        return 1
    for r, out in enumerate(outs):
        print(f"--- rank {r} ---\n{out}", end="" if out.endswith("\n")
              else "\n")
    return 0


__all__ = ["NamedSharding", "PendingReduce",
           "ProcessMesh", "STORE_ENV", "TracingMesh", "choose_backend",
           "destroy_process_group", "init_process_group", "process_group",
           "rank", "shardings", "world_size"]


if __name__ == "__main__":
    raise SystemExit(main())
