"""Compiled segment runtime: executes a placed program as CUDA graphs
(the port's side of the reference's ``repro/core/runtime.py``).

Where ``core.executor.execute`` replays the traced program one aten call
at a time (the reference the runtime is held to), this runtime lowers
the placement into per-PE subprograms with explicit transfers:

* Each :class:`~repro_torch.core.segments.Segment` becomes one CUDA
  graph, captured once and replayed on its PE's ``torch.cuda.Stream``
  at every later call. The reference compiles each segment ahead of
  time with ``jax.jit``; here the first call runs every segment eagerly
  as a warm-up (cuBLAS handles and workspaces), then captures the
  segments in schedule order. Warm-up and capture time go into
  ``compile_seconds``, apart from run time.
* **One graph pool per device.** The PEs that lie on one device (a
  ``device_map`` that folds them) capture into one pool, as the
  reference's folded PEs share one XLA allocator; PEs on distinct
  devices have a pool each. During capture, a value's Python reference
  is dropped after its last consuming segment (the refcounts derived
  from the trace-time liveness table), and a later segment captured into
  the same pool, on any PE, reuses the memory. PyTorch's allocator
  hands a freed block only to an allocation on the stream it was made
  on, so every segment of a device is captured on one capture stream
  (and warmed up there), and replayed on its PE's stream: a graph runs
  on the stream that replays it.
* **Replay order in a shared pool.** Graphs that share a pool may
  replay only in capture order and never at once: a block freed inside
  one segment's capture may serve the next segment's, on another PE,
  and the segments captured on one stream share its cuBLAS workspace.
  So each segment waits, at every replay, on the event recorded after
  the segment captured before it on its device, when that one ran on
  another PE. The PEs of one device still dispatch without blocking the
  host, but their segments run one after another on the card.
* **Reads across devices.** Captured graphs have no ``record_stream``.
  When the last value that lies in a block of device a's pool is
  dropped, a later capture on device a may reuse the block while a copy
  to device b, on b's stream, still reads it. The rule is kept per
  storage, not per node: a view of a tensor in a's pool keeps a's block
  alive, and the block goes back to a's pool only when the last of its
  aliases drops (:class:`_PoolOwners`). Then the next segment captured
  on device a waits, at every replay, on the event recorded after the
  last segment on each other device that read or made any of those
  aliases. ``RuntimeStats.reuse_waits`` counts these waits and those of
  the replay order above.
* A cross-PE read between PEs folded onto one device (``device_map=[0]
  * k``) is not copied: the consumer's stream waits on an event
  recorded after the producing segment. It counts in ``transfers`` and
  ``transfer_bytes``, and apart as ``aliased_reads``. Between PEs on
  different devices it is a copy into a buffer on the consumer's device,
  issued on the consumer's stream.
* **Static inputs and outputs.** A graph reads its inputs at the
  addresses it saw at capture. The leaves of the positional arguments
  named in ``static_argnums`` (the parameters) are read where the first
  call passed them (or from a copy made then on their PE's device): a
  later call must pass the same tensors, and one that passes another
  tensor raises. Every other leaf is cloned into a buffer of the
  runtime's own at the first call and copied into it at every call
  (``input_copies``, ``input_copy_bytes``); the caller's tensors are
  never written. Outputs live in the graph pools and the next replay
  overwrites them, so a call returns clones (``output_clone_bytes``).
* **Donation** (``donate=True``, the default, as the reference's). A
  segment input that dies there (``Segment.dead_inputs``) is donated:
  the runtime drops its own references before the segment runs and the
  segment drops the value after its last reader inside it, so that the
  block serves the segment's later allocations (at capture, and so at
  every replay). Where PEs fold onto one device, a cross-PE read is the
  producer's own tensor, donated only when the producer is a program
  node, no program output, and this segment its last consumer, as the
  reference masks it (``_effective_donations``). Program inputs,
  constants, and the runtime's input and copy buffers are never
  donated, and the caller's tensors never written. A functional write
  of the kinds in ``_INPLACE`` (the ones granite-8b's decode and
  training programs hold) runs in place into its base, XLA's
  input-output alias, when the base is donated there or is a local that
  dies there, is contiguous (so the functional op's output would have
  its shape, dtype and strides), and no other value the runtime holds
  lies in its storage; else it runs as recorded. ``donate=False``
  donates nothing and writes nothing in place. A transferred copy lives
  until its source's last consuming segment (the reference donates a
  copy at its last reader on that device).
* **CPU.** With CPU devices (the tests) the segments run as plain
  Python replays in schedule order: no streams, no capture, donation
  and in-place writes as on the card. That is the runtime's plain
  version. With CUDA devices it always captures, and a
  node that cannot be captured (one that syncs with the host) raises,
  naming the segment, the node and its op.

Dispatch modes (``mode``, default resolved from ``REPRO_RUNTIME_SYNC``):

* ``"async"``: the Python loop dispatches segments in schedule order
  without blocking; each PE's stream runs its segments, ordered against
  the other PEs by events. Cross-device copies are prefetched at their
  producer's dispatch from ``SegmentSchedule.prefetch``, under the
  in-flight transfer window (``transfer_window_bytes``); one that would
  pass the window is deferred to its consumer.
* ``"sync"``: every transfer issued at its consumer, and the stream
  synchronised after every segment.

Both modes replay the same graphs on the same values in the same order,
so their outputs are bit-identical. Per-segment profiling
(``profile_segments = True``, which ``repro_torch.profiling.
profile_segments`` sets) forces the sync mode and records each
segment's seconds in ``RuntimeStats.segment_seconds``: on CUDA from a
pair of timing events around its graph replay (after its waits and
copies), on the CPU from the host's clock around its run.
:meth:`CompiledRuntime.measure_timeline`
runs one call that also records when each segment ran: on CUDA by timing
events on each PE's stream (the card's clock), on the CPU by host
timestamps; a plain call records none. The logical per-PE live bytes
(``peak_live_bytes``) follow the refcount schedule as the reference's
do, a donated input's bytes released before its segment's outputs are
charged; the tests hold the runtime to the interpreter and to the eager step
bit for bit on the CPU, and ``chip_smoke.py`` on the card.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..tree import tree_flatten, tree_unflatten
from .executor import (TracedProgram, node_kwargs, run_node,
                       validate_device_count)
from .segments import Segment, SegmentSchedule, Slot, cut_segments

#: Default cap on live prefetched-transfer bytes (the in-flight window).
#: A prefetch that would push the live transferred-copy total past this
#: is deferred to its consumer. Override per runtime via the
#: ``transfer_window_bytes`` argument or ``REPRO_TRANSFER_WINDOW_MB``.
DEFAULT_TRANSFER_WINDOW_BYTES: float = 64 * 1024 * 1024


def resolve_runtime_mode(mode: str | None = None) -> str:
    """Dispatch-mode resolution shared by the runtime and the facade:
    explicit argument first, then the ``REPRO_RUNTIME_SYNC=1`` escape
    hatch, else the overlapped default."""
    if mode is None:
        mode = "sync" if os.environ.get("REPRO_RUNTIME_SYNC") == "1" \
            else "async"
    if mode not in ("async", "sync"):
        raise ValueError(f"runtime mode must be 'async' or 'sync', "
                         f"got {mode!r}")
    return mode


def _resolve_window(window: float | None) -> float:
    if window is not None:
        return float(window)
    env = os.environ.get("REPRO_TRANSFER_WINDOW_MB")
    if env is not None:
        return float(env) * 1024 * 1024
    return DEFAULT_TRANSFER_WINDOW_BYTES


@dataclass
class RuntimeStats:
    """Counters from building/running a :class:`CompiledRuntime`."""
    num_segments: int = 0
    segments_per_device: list = field(default_factory=list)
    num_transfer_edges: int = 0        # static cross-device slot reads
    compile_seconds: float = 0.0       # warm-up + capture, cumulative
    calls: int = 0
    # event waits added so that no segment reuses memory that another
    # PE's stream may still read (the replay order of a shared pool and
    # the cross-device rule)
    reuse_waits: int = 0
    # segment inputs donated over the schedule, their bytes, and the
    # functional writes run in place (at capture on CUDA; the last call
    # on the CPU)
    donated_inputs: int = 0
    donated_bytes: float = 0.0
    inplace_writes: int = 0
    # per-call counters (the last call's values):
    mode: str = ""                     # dispatch mode that produced them
    transfers: int = 0                 # cross-PE reads: copies + aliased
    prefetched_transfers: int = 0      # copies issued at producer dispatch
    deferred_transfers: int = 0        # prefetches pushed past the window
    transfer_bytes: float = 0.0
    aliased_reads: int = 0             # cross-PE reads on a shared device
    aliased_read_bytes: float = 0.0
    transfer_window_bytes: float = 0.0
    peak_inflight_transfer_bytes: float = 0.0   # live transferred copies
    graph_replays: int = 0             # segments replayed from a graph
    eager_segments: int = 0            # segments run op by op
    input_copies: int = 0              # leaves copied into owned buffers
    input_copy_bytes: float = 0.0
    output_clone_bytes: float = 0.0
    execute_seconds: float = 0.0       # compile excluded
    freed_buffers: int = 0
    peak_live_bytes: list = field(default_factory=list)   # per device
    resident_bytes: list = field(default_factory=list)    # inputs+consts
    # per segment, in schedule order, from the last measure_timeline call
    # (empty after a plain call); seconds from the call's start
    dispatch_seconds: list = field(default_factory=list)  # host clock
    ready_seconds: list = field(default_factory=list)
    done_seconds: list = field(default_factory=list)
    transfer_wait_seconds: list = field(default_factory=list)
    # per segment, in schedule order, when the runtime's
    # profile_segments mode is on (empty otherwise): the seconds of its
    # replay alone, segments serialised
    segment_seconds: list = field(default_factory=list)

    def to_dict(self) -> dict:
        d = {}
        for k, v in self.__dict__.items():
            if isinstance(v, list):
                d[k] = [float(x) if isinstance(x, float) else int(x)
                        for x in v]
            else:
                d[k] = v
        return d

    def timeline(self) -> dict:
        """The last measured per-segment timeline as one dict (empty
        lists unless the call came from ``measure_timeline``);
        ``makespan_s`` is the last segment's done time, or the call's
        execute seconds without a timeline."""
        return {
            "mode": str(self.mode),
            "dispatch_s": [float(x) for x in self.dispatch_seconds],
            "ready_s": [float(x) for x in self.ready_seconds],
            "done_s": [float(x) for x in self.done_seconds],
            "transfer_wait_s": [float(x) for x in
                                self.transfer_wait_seconds],
            "makespan_s": float(max(self.done_seconds,
                                    default=self.execute_seconds)),
        }


def _nbytes(v: Any) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return 0


def _storage_key(v: Any) -> int | None:
    """The storage a tensor lies in (its base address), shared by all of
    its views; None for a non-tensor or an empty storage."""
    if not isinstance(v, torch.Tensor):
        return None
    storage = v.untyped_storage()
    return storage.data_ptr() if storage.nbytes() else None


#: functional writes into a base that the segment runtime may run in
#: place, each with its in-place form: the functional op is the in-place
#: one on ``base.clone()``, so both give the same bits. The list is the
#: functional writes that granite-8b's decode step (``index_put``: each
#: layer's cache write and the pool scatter) and training step
#: (``index_put``, ``scatter_add``) hold.
_INPLACE = {
    torch.ops.aten.index_put.default: torch.ops.aten.index_put_.default,
    torch.ops.aten.scatter_add.default:
        torch.ops.aten.scatter_add_.default,
}


class _PoolOwners:
    """During capture: which graph pool holds each storage that a
    segment's output lies in, which live slots alias it, and the last
    segment on each pool's device that read or made one of those slots.

    A storage first seen as an output of a segment captured into pool p
    was allocated from p; a later output that lies in it (a view, on any
    PE) joins its aliases. The block goes back to p when the last alias
    drops: :meth:`dropped` then returns p and the segments on other
    pools' devices that p's next capture must wait for. Storages the
    runtime holds for the whole call (inputs, constants, copy buffers)
    are pinned and never returned."""

    def __init__(self):
        self._owner: dict[int, int | None] = {}      # storage -> pool
        self._aliases: dict[int, set[Slot]] = {}     # storage -> live slots
        self._touched: dict[int, dict[int, int]] = {}  # storage -> pool -> sid
        self._storage: dict[Slot, int] = {}

    def pin(self, v: Any) -> None:
        key = _storage_key(v)
        if key is not None:
            self._owner[key] = None

    def produced(self, slot: Slot, v: Any, pool: int, sid: int) -> None:
        key = _storage_key(v)
        if key is None:
            return
        self._owner.setdefault(key, pool)
        if self._owner[key] is None:
            return
        self._aliases.setdefault(key, set()).add(slot)
        self._storage[slot] = key
        self.read(slot, pool, sid)

    def read(self, slot: Slot, pool: int, sid: int) -> None:
        key = self._storage.get(slot)
        if key is not None:
            touched = self._touched.setdefault(key, {})
            touched[pool] = max(touched.get(pool, -1), sid)

    def dropped(self, slot: Slot) -> tuple[int, set[int]] | None:
        """``slot`` is dropped: when it was the last alias of its
        storage, (the owning pool, the segments on other pools' devices
        to wait for), else None."""
        key = self._storage.pop(slot, None)
        if key is None:
            return None
        aliases = self._aliases[key]
        aliases.discard(slot)
        if aliases:
            return None
        owner = self._owner.pop(key)
        del self._aliases[key]
        touched = self._touched.pop(key, {})
        return owner, {sid for pool, sid in touched.items()
                       if pool != owner}


def _make_segment_fn(prog: TracedProgram, seg: Segment, device,
                     donated: tuple[int, ...] | None = None):
    """The Python callable replaying ``seg``'s nodes on ``device``; the
    segment's CUDA graph is a capture of one call of it. A node's value
    is dropped after its last reader inside the segment unless the
    segment exports it, so that a long segment (the whole step at K=1)
    holds no more than the eager step does; so is each ``donated`` input
    position's value (None: no donation and no write in place).

    It is called as ``fn(invals, shared)``: ``invals`` the list of input
    values, which it empties (the caller keeps no reference to a donated
    one), ``shared`` the storages of the values the caller still holds.
    A functional write of ``_INPLACE`` whose base (its first argument)
    is a donated input or a local that dies at that node runs in place
    when the base is contiguous and no other live value, here or in
    ``shared``, lies in the base's storage. ``fn.inplace_writes`` is the
    number of such writes in its last call."""
    kwargs = {nid: node_kwargs(prog.program[nid][1], device)
              for nid in seg.nodes}
    exported = {src for src, _ in seg.outputs}
    last_read: dict[int, int] = {}
    slot_read: dict[Slot, int] = {}
    for nid in seg.nodes:
        for inp in prog.program[nid][2]:
            if inp[0] == "slot":
                last_read[inp[1]] = nid
                slot_read[(inp[1], inp[2])] = nid
    free_after: dict[int, list[int]] = {}
    for src, nid in last_read.items():
        if src in kwargs and src not in exported:
            free_after.setdefault(nid, []).append(src)
    drop_after: dict[int, list[Slot]] = {}
    for pos in donated or ():
        slot = seg.inputs[pos]
        drop_after.setdefault(slot_read[slot], []).append(slot)
    # functional writes whose base dies at the node (the base read once)
    candidates: dict[int, Slot] = {}
    for nid in seg.nodes if donated is not None else ():
        op, _, inputs = prog.program[nid]
        if op not in _INPLACE or not inputs or inputs[0][0] != "slot":
            continue
        base = (inputs[0][1], inputs[0][2])
        if sum(inp[0] == "slot" and (inp[1], inp[2]) == base
               for inp in inputs) != 1:
            continue
        if base[0] in free_after.get(nid, ()) or \
                base in drop_after.get(nid, ()):
            candidates[nid] = base

    def fn(invals: list, shared=frozenset()):
        env: dict[Slot, Any] = dict(zip(seg.inputs, invals))
        invals.clear()
        local: dict[int, Any] = {}
        inplace = 0

        def read(src: int, idx: int):
            if src in local:
                v = local[src]
                return v[idx] if isinstance(v, (tuple, list)) else v
            return env[(src, idx)]

        def sole(base_slot: Slot, base) -> bool:
            """No live value but ``base`` lies in its storage."""
            key = _storage_key(base)
            if key is None or key in shared:
                return False
            if any(slot != base_slot and _storage_key(v) == key
                   for slot, v in env.items()):
                return False
            for src, v in local.items():
                vs = v if isinstance(v, (tuple, list)) else (v,)
                if any((src, i) != base_slot and _storage_key(t) == key
                       for i, t in enumerate(vs)):
                    return False
            return True

        nid = -1
        try:
            for nid in seg.nodes:
                vals = [inp[1] if inp[0] == "lit" else read(inp[1], inp[2])
                        for inp in prog.program[nid][2]]
                base = candidates.get(nid)
                if base is not None and isinstance(vals[0], torch.Tensor) \
                        and vals[0].is_contiguous() and sole(base, vals[0]):
                    local[nid] = run_node(prog, nid, vals, kwargs[nid],
                                          _INPLACE[prog.program[nid][0]])
                    inplace += 1
                else:
                    local[nid] = run_node(prog, nid, vals, kwargs[nid])
                del vals
                for src in free_after.get(nid, ()):
                    del local[src]
                for slot in drop_after.get(nid, ()):
                    del env[slot]
        except RuntimeError as e:
            raise RuntimeError(
                f"segment {seg.sid} (pe {seg.device}), node {nid} "
                f"({prog.program[nid][0]}): {e}") from e
        fn.inplace_writes = inplace
        return tuple(read(src, idx) for src, idx in seg.outputs)

    fn.candidates = candidates
    fn.inplace_writes = 0
    return fn


class CompiledRuntime:
    """Execute a placed :class:`TracedProgram` as captured segments.

    Args:
        prog: recorded program (``trace(..., record=True)``).
        assignment: node -> pe (None: every node on PE 0).
        devices: ``torch.device`` per pe, all CUDA or all the CPU; must
            cover every pe the assignment uses (no silent aliasing;
            expand the list explicitly to share devices). ``None``:
            ``cuda``, which raises on a machine without one.
        donate: donate dead segment inputs and run functional writes
            into them in place (default True, as the reference's); see
            the module docstring. ``False``: free by liveness alone.
        static_argnums: positional arguments whose leaves the graphs
            read in place (the parameters): every later call must pass
            the same tensors. The other leaves are copied into buffers
            the runtime owns.
        mode: ``"async"`` (overlapped, default) or ``"sync"``
            (serialized); ``None`` resolves ``REPRO_RUNTIME_SYNC``.
            Mutable attribute: flip it between calls.
        transfer_window_bytes: cap on live prefetched-copy bytes
            (``None``: ``REPRO_TRANSFER_WINDOW_MB`` env or the 64 MiB
            default; ``0`` disables prefetching).

    The instance is reusable: on CUDA the segments are captured at the
    first call and replayed after that.
    """

    def __init__(self, prog: TracedProgram, assignment: np.ndarray | None,
                 devices: list | None, *, donate: bool = True,
                 static_argnums: tuple[int, ...] = (),
                 mode: str | None = None,
                 transfer_window_bytes: float | None = None):
        devices = [resolve_device(d) for d in devices or [None]]
        kinds = {d.type for d in devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"the PEs' devices must be all CUDA or all the "
                             f"CPU, got {[str(d) for d in devices]}")
        self.capture = "cuda" in kinds
        if self.capture:
            devices = [torch.device("cuda", torch.cuda.current_device())
                       if d.index is None else d for d in devices]
        validate_device_count(assignment, devices)
        self.prog = prog
        self.assignment = assignment
        self.devices = devices
        self.donate = donate
        self.static_argnums = tuple(int(i) for i in static_argnums)
        self.mode = resolve_runtime_mode(mode)
        self.transfer_window_bytes = _resolve_window(transfer_window_bytes)
        self.schedule: SegmentSchedule = cut_segments(
            prog, assignment, k=len(devices))
        sched = self.schedule
        self.stats = RuntimeStats(
            num_segments=sched.num_segments,
            segments_per_device=sched.segments_per_device(),
            num_transfer_edges=sched.num_transfer_edges)
        # the distinct devices: one graph pool (and capture stream) each
        self._pool_devices = list(dict.fromkeys(devices))
        self._pool_of = [self._pool_devices.index(d) for d in devices]
        _, output_nodes = prog.liveness()
        self.donated: list[tuple[int, ...]] = [
            self._donations(seg, output_nodes) if donate else ()
            for seg in sched.segments]
        self.stats.donated_inputs = sum(map(len, self.donated))
        self._fns = [_make_segment_fn(prog, seg, devices[seg.device],
                                      dn if donate else None)
                     for seg, dn in zip(sched.segments, self.donated)]
        # consts are placed once and pinned for the runtime's lifetime
        self._const_vals = {nid: cval.to(self._dev_of(nid))
                            if isinstance(cval, torch.Tensor) else cval
                            for nid, cval in prog.const_nodes}
        # static index: exported slots per producer (for O(deg) freeing),
        # boundary slots fed by graph inputs/consts, and per segment the
        # segments on other PEs whose outputs it reads (event waits)
        self._slots_by_producer: dict[int, list[Slot]] = {}
        self._root_slots: list[Slot] = []
        roots = set(self._const_vals) | set(prog.input_nodes)
        seen_root: set[Slot] = set()
        self._waits: list[tuple[int, ...]] = []
        for seg in sched.segments:
            for slot in seg.outputs:
                self._slots_by_producer.setdefault(slot[0], []).append(slot)
            for slot in seg.inputs:
                if slot[0] in roots and slot not in seen_root:
                    seen_root.add(slot)
                    self._root_slots.append(slot)
            self._waits.append(tuple(sorted({
                sched.producer_seg[slot] for slot in seg.inputs
                if sched.producer_seg.get(slot, -1) >= 0
                and sched.segments[sched.producer_seg[slot]].device
                != seg.device})))
        for slot in prog.out_slots:
            if slot is not None and slot[0] in roots \
                    and slot not in seen_root:
                seen_root.add(slot)
                self._root_slots.append(slot)
        # byte size of every slot (static shapes), filled as values appear
        self._slot_bytes: dict[Slot, int] = {}
        # capture state (CUDA): a replay stream per PE, a capture stream
        # and a graph pool per device, an event per segment, the graphs,
        # the tensors they read and write
        self._graphs: list | None = None
        self._streams: list = []
        self._capture_streams: list = []
        self._events: list = []
        self._pools: list = []
        self._static_in: list = []
        # per leaf: the caller's tensor of a static argument (read in
        # place, or from a copy on its PE's device), else None
        self._borrowed: list = []
        self._static_out: dict[Slot, torch.Tensor] = {}
        self._copy_src: dict[tuple[Slot, int], torch.Tensor] = {}
        self._copy_dst: dict[tuple[Slot, int], torch.Tensor] = {}
        # set by measure_timeline for one call: record segment times
        self._timeline = False
        # per-segment profiling mode (repro_torch.profiling flips it):
        # forces sync dispatch and records RuntimeStats.segment_seconds;
        # off by default, since serialising defeats the overlap
        self.profile_segments = False

    # ------------------------------------------------------------------
    def _donations(self, seg: Segment, output_nodes) -> tuple[int, ...]:
        """The input positions ``seg`` donates: ``Segment.dead_inputs``,
        masked as the reference's ``_effective_donations`` masks them. A
        cross-PE read on a shared device is the producer's own tensor,
        donated only when the producer is a program node, no program
        output, and ``seg`` its last consumer; a read from another
        device is a copy into a buffer the runtime keeps, never
        donated."""
        transfer = set(seg.transfer_inputs)
        out = []
        for pos in seg.dead_inputs:
            slot = seg.inputs[pos]
            if pos in transfer:
                if not self._aliased(slot, seg.device):
                    continue
                if not (slot[0] in self.prog.program
                        and slot[0] not in output_nodes
                        and self.schedule.last_consumer_seg.get(slot[0])
                        == seg.sid):
                    continue
            out.append(pos)
        return tuple(out)

    def _shared(self, env: dict, seg: Segment) -> frozenset:
        """The storages of the values held outside ``seg`` (the sweep's
        environment and the copy buffers), where the segment has a write
        that may run in place; else empty."""
        if not self._fns[seg.sid].candidates:
            return frozenset()
        keys = {_storage_key(v) for v in env.values()}
        keys.update(_storage_key(v) for d in (self._copy_src, self._copy_dst)
                    for v in d.values())
        keys.discard(None)
        return frozenset(keys)

    def _pe_of(self, nid: int) -> int:
        return 0 if self.assignment is None else int(self.assignment[nid])

    def _dev_of(self, nid: int):
        return self.devices[self._pe_of(nid)]

    def _aliased(self, slot: Slot, pe: int) -> bool:
        """A cross-PE read that needs no copy: both PEs on one device."""
        return self._dev_of(slot[0]) == self.devices[pe]

    def _current_streams(self) -> list:
        """The caller's current stream on each PE's device (and on the
        current device): where inputs were written and where outputs
        are cloned."""
        devs = dict.fromkeys([torch.device("cuda",
                                           torch.cuda.current_device())]
                             + self.devices)
        return [torch.cuda.current_stream(d) for d in devs]

    def _synchronize(self) -> None:
        for d in dict.fromkeys(self.devices):
            torch.cuda.synchronize(d)

    def _roots(self, flat: list) -> dict[int, Any]:
        vals: dict[int, Any] = dict(self._const_vals)
        for nid, a in zip(self.prog.input_nodes, flat):
            vals[nid] = a.to(self._dev_of(nid)) \
                if isinstance(a, torch.Tensor) else a
        for nid, v in vals.items():
            self._slot_bytes[(nid, 0)] = _nbytes(v)
        return vals

    # ------------------------------------------------------------------
    def _build(self, args: tuple, flat: list) -> None:
        """First CUDA call: the input buffers, a warm-up of every segment
        on its device's capture stream, then one capture per segment in
        schedule order."""
        t0 = time.perf_counter()
        self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
        self._capture_streams = [torch.cuda.Stream(device=d)
                                 for d in self._pool_devices]
        self._events = [torch.cuda.Event() for _ in self.schedule.segments]
        self._pools = [torch.cuda.graph_pool_handle()
                       for _ in self._pool_devices]
        static = []
        for i, a in enumerate(args):
            static += [i in self.static_argnums] * len(tree_flatten(a)[0])
        static += [False] * (len(flat) - len(static))
        self._borrowed = [a if s else None for a, s in zip(flat, static)]
        node_vals = self._roots(flat)
        owned = [(nid, a) for nid, a, s in zip(self.prog.input_nodes, flat,
                                               static)
                 if not s and isinstance(a, torch.Tensor)]
        for nid, a in owned:
            node_vals[nid] = a.to(self._dev_of(nid), copy=True)
        self._static_in = [node_vals[nid] for nid in self.prog.input_nodes]
        self.stats.input_copies = len(owned)
        self.stats.input_copy_bytes = float(sum(_nbytes(a) for _, a in owned))
        self._synchronize()
        self._sweep(node_vals, capture=False)
        self._synchronize()
        # the allocator frees no cached block while a capture is under
        # way: hand back the warm-up's before the graph pools grow
        torch.cuda.empty_cache()
        self._graphs = []
        env = self._sweep(node_vals, capture=True)
        self.stats.inplace_writes = sum(f.inplace_writes for f in self._fns)
        self._static_out = {slot: env[slot] for slot in self.prog.out_slots
                            if slot is not None}
        self._synchronize()
        self.stats.compile_seconds += time.perf_counter() - t0

    def _sweep(self, node_vals: dict, *, capture: bool) -> dict:
        """Every segment in schedule order on its device's capture
        stream: run eagerly and synchronised (the warm-up), or captured
        into its graph. Values are dropped after their last consuming
        segment, donated ones before it; while capturing, each segment
        gets the waits of its pool's replay order, and the drop of the
        last value in a block of a pool those of the segments on other
        devices that read it. Returns the environment left at the end
        (the program's outputs)."""
        sched = self.schedule
        env: dict[Slot, Any] = {slot: node_vals[slot[0]]
                                for slot in self._root_slots}
        refcount = dict(sched.node_refcount)
        copies: dict[tuple[Slot, int], torch.Tensor] = {}
        owners = _PoolOwners()
        for v in env.values():
            owners.pin(v)
        # per pool: segments on other devices that read memory dropped
        # from it, which its next captured segment must wait for; and
        # the (pe, segment) captured into it last
        pending: list[set[int]] = [set() for _ in self._pools]
        last: list[tuple[int, int] | None] = [None] * len(self._pools)
        for seg in sched.segments:
            pool = self._pool_of[seg.device]
            dev, stream = self.devices[seg.device], \
                self._capture_streams[pool]
            invals, v = [], None
            for slot in seg.inputs:
                v = env[slot]
                owners.read(slot, pool, seg.sid)
                if self._pe_of(slot[0]) != seg.device:
                    if not self._aliased(slot, seg.device):
                        key = (slot, seg.device)
                        if capture:
                            self._copy_src[key] = v
                            if key not in self._copy_dst:
                                self._copy_dst[key] = torch.empty_like(
                                    v, device=dev)
                            v = self._copy_dst[key]
                            owners.pin(v)
                        else:
                            if key not in copies:
                                with torch.cuda.stream(stream):
                                    copies[key] = v.to(dev)
                            v = copies[key]
                invals.append(v)
            del v
            # donated inputs: the segment holds the only references, and
            # may hand their blocks to its own allocations
            for pos in self.donated[seg.sid]:
                slot = seg.inputs[pos]
                del env[slot]
                freed = owners.dropped(slot)
                if freed is not None:
                    pending[freed[0]].update(freed[1])
            shared = self._shared(env, seg)
            if capture:
                new = pending[pool]
                pending[pool] = set()
                if last[pool] is not None and last[pool][0] != seg.device:
                    new.add(last[pool][1])
                new -= set(self._waits[seg.sid])
                self._waits[seg.sid] = tuple(sorted(
                    new.union(self._waits[seg.sid])))
                self.stats.reuse_waits += len(new)
                last[pool] = (seg.device, seg.sid)
                outs = self._capture(seg, stream, invals, shared)
            else:
                with torch.cuda.stream(stream):
                    outs = self._fns[seg.sid](invals, shared)
                stream.synchronize()
            for slot, v in zip(seg.outputs, outs):
                env[slot] = v
                self._slot_bytes[slot] = _nbytes(v)
                owners.produced(slot, v, pool, seg.sid)
            outs = v = None
            for src in {s[0] for s in seg.inputs}:
                if src not in refcount:
                    continue
                refcount[src] -= 1
                if refcount[src] != 0:
                    continue
                for key in [k for k in copies if k[0][0] == src]:
                    del copies[key]
                if src in node_vals:
                    continue
                for slot in self._slots_by_producer.get(src, ()):
                    if slot not in env:
                        continue            # donated
                    del env[slot]
                    freed = owners.dropped(slot)
                    if freed is not None:
                        pending[freed[0]].update(freed[1])
        return env

    def _capture(self, seg: Segment, stream, invals: list,
                 shared: frozenset) -> tuple:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), warnings.catch_warnings():
            # a segment of views alone launches nothing: an empty graph
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
            graph.capture_begin(pool=self._pools[self._pool_of[seg.device]])
            try:
                outs = self._fns[seg.sid](invals, shared)
            except RuntimeError as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise RuntimeError(
                    f"cannot capture segment {seg.sid} into a CUDA graph: "
                    f"{e}") from e
            graph.capture_end()
        self._graphs.append(graph)
        return outs

    def _set_inputs(self, flat: list) -> tuple[int, float]:
        """Copy each input leaf into the runtime's buffer the graphs read
        it from; a leaf read in place must be the tensor the first call
        passed. Returns (copies, bytes)."""
        n, nb = 0, 0.0
        for i, (a, static, given) in enumerate(
                zip(flat, self._static_in, self._borrowed)):
            if a.shape != static.shape or a.dtype != static.dtype:
                raise ValueError(
                    f"input leaf {i}: {tuple(a.shape)} {a.dtype}, but the "
                    f"graphs were captured for {tuple(static.shape)} "
                    f"{static.dtype}")
            if given is not None:
                if a.data_ptr() != given.data_ptr() or a.device != \
                        given.device or a.stride() != given.stride():
                    raise ValueError(
                        f"input leaf {i} belongs to a static argument "
                        f"(static_argnums={self.static_argnums}), which "
                        f"the captured graphs read in place: pass the "
                        f"tensor the first call passed, or build a new "
                        f"runtime")
                continue
            static.copy_(a)
            n += 1
            nb += _nbytes(a)
        return n, nb

    # ------------------------------------------------------------------
    def measure_timeline(self, *args, **kwargs):
        """One call that also records when each segment ran. Returns
        ``(result, timeline)``: the :meth:`RuntimeStats.timeline` dict,
        whose lists hold, per segment in schedule order, seconds from
        the call's start:

        * ``dispatch_s``: the host's clock when the segment had been
          dispatched (its graph replay enqueued, or on the CPU, run);
        * ``ready_s`` / ``done_s``: on CUDA, the card's clock, from
          timing events recorded on the PE's stream after the segment's
          waits on other PEs and its copies, and after its replay,
          measured from an event recorded on the caller's stream of
          that device at the call's start; on the CPU, the host's clock
          before and after the segment ran;
        * ``transfer_wait_s``: on CUDA, how long the PE's stream stood
          between the end of its previous work and the segment's start,
          waiting on the segments of other PEs it reads and on its
          copies; 0 on the CPU.

        The dispatch is the plain call's: the events are recorded beside
        it, and only in this call (the first call captures the graphs
        first and times the replays after)."""
        self._timeline = True
        try:
            result = self(*args, **kwargs)
        finally:
            self._timeline = False
        return result, self.stats.timeline()

    def __call__(self, *args, **kwargs):
        prog, sched = self.prog, self.schedule
        flat, _ = tree_flatten((args, kwargs))
        if len(flat) != len(prog.input_nodes):
            raise ValueError(f"expected {len(prog.input_nodes)} leaves, "
                             f"got {len(flat)}")
        # profiling waits after every segment anyway, so it forces the
        # serialised mode for attributable timings
        profiling = self.profile_segments
        sync = self.mode == "sync" or profiling
        window = 0.0 if sync else float(self.transfer_window_bytes)
        st = self.stats
        first = self.capture and self._graphs is None
        if first:
            self._build(args, flat)
        t_start = time.perf_counter()
        timed = self._timeline
        # per segment: (pre, ready, done) timing events on CUDA, or
        # (ready, done) host seconds on the CPU; dispatch host seconds
        marks: list = []
        dispatched: list[float] = []
        seg_seconds: list[float] = []
        bases: dict = {}
        if timed and self.capture:
            for d in dict.fromkeys(self.devices):
                bases[d] = torch.cuda.Event(enable_timing=True)
                bases[d].record(torch.cuda.current_stream(d))
        k = len(self.devices)
        live = np.zeros(k, dtype=np.float64)
        peak = np.zeros(k, dtype=np.float64)
        freed = 0
        refcount = dict(sched.node_refcount)
        st.mode = "sync" if sync else "async"
        st.transfers = st.prefetched_transfers = st.deferred_transfers = 0
        st.aliased_reads = st.graph_replays = st.eager_segments = 0
        st.transfer_bytes = st.aliased_read_bytes = 0.0
        st.transfer_window_bytes = window
        st.peak_inflight_transfer_bytes = 0.0
        if not first:
            st.input_copies, st.input_copy_bytes = 0, 0.0
        st.output_clone_bytes = 0.0
        inflight = 0.0                  # live transferred-copy bytes
        nbytes = self._slot_bytes

        def alloc(pe: int, nb: float) -> None:
            live[pe] += nb
            if live[pe] > peak[pe]:
                peak[pe] = live[pe]

        # inputs/consts are resident for the whole call (the paper's
        # res_ns) on their assigned PEs
        env: dict[Slot, Any] = {}
        if self.capture:
            if not first:
                st.input_copies, st.input_copy_bytes = \
                    self._set_inputs(flat)
            currents = self._current_streams()
            for c in currents:
                start = c.record_event()
                for s in self._streams:
                    s.wait_event(start)
        else:
            node_vals = self._roots(flat)
            for slot in self._root_slots:
                env[slot] = node_vals[slot[0]]
        for nid in list(self._const_vals) + list(prog.input_nodes):
            alloc(self._pe_of(nid), nbytes[(nid, 0)])
        resident = live.copy()

        # donated inputs, released before their segment's outputs
        released: set[Slot] = set()
        inplace = 0

        # copies between devices, one per (slot, target pe), live until
        # their source's last consuming segment has run
        copied: set[tuple[Slot, int]] = set()
        copies_by_src: dict[int, list[tuple[Slot, int]]] = {}
        aliased: set[tuple[Slot, int]] = set()

        def copy(key, stream, after: int) -> float:
            """Issue one copy on ``stream`` once ``after`` (a segment,
            or -1: the call's start) has produced its source."""
            nonlocal inflight
            if after >= 0:
                stream.wait_event(self._events[after])
            with torch.cuda.stream(stream):
                self._copy_dst[key].copy_(self._copy_src[key],
                                          non_blocking=True)
            nb = float(nbytes[key[0]])
            st.transfers += 1
            st.transfer_bytes += nb
            alloc(key[1], nb)
            inflight += nb
            st.peak_inflight_transfer_bytes = max(
                st.peak_inflight_transfer_bytes, inflight)
            copied.add(key)
            copies_by_src.setdefault(key[0][0], []).append(key)
            return nb

        def issue_prefetch(psid: int) -> None:
            """Start the copies of ``psid``'s exports to other devices
            the moment the producer is dispatched. Never blocks: a copy
            that would push live copied bytes past the window is
            deferred to its consumer."""
            for slot, dst_pe in sched.prefetch.get(psid, ()):
                key = (slot, dst_pe)
                if self._aliased(slot, dst_pe) or key in copied:
                    continue
                if inflight + nbytes[slot] > window:
                    st.deferred_transfers += 1
                    continue
                copy(key, self._streams[dst_pe], psid)
                st.prefetched_transfers += 1

        if self.capture and not sync:
            issue_prefetch(-1)          # graph inputs/consts

        for seg in sched.segments:
            stream = self._streams[seg.device] if self.capture else None
            if stream is not None and timed:
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(3)]
                ev[0].record(stream)
                marks.append(ev)
            if stream is not None:
                for p in self._waits[seg.sid]:
                    stream.wait_event(self._events[p])
            for pos in seg.transfer_inputs:
                slot = seg.inputs[pos]
                key = (slot, seg.device)
                if self._aliased(slot, seg.device):
                    if key not in aliased:
                        aliased.add(key)
                        st.aliased_reads += 1
                        st.aliased_read_bytes += nbytes[slot]
                        st.transfers += 1
                        st.transfer_bytes += nbytes[slot]
                elif key not in copied:
                    # sync mode, or a prefetch the window deferred
                    copy(key, stream, sched.producer_seg.get(slot, -1))
            if stream is not None:
                if timed:
                    marks[-1][1].record(stream)
                if profiling:
                    span = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
                    span[0].record(stream)
                with torch.cuda.stream(stream):
                    self._graphs[seg.sid].replay()
                self._events[seg.sid].record(stream)
                if timed:
                    marks[-1][2].record(stream)
                if profiling:
                    span[1].record(stream)
                st.graph_replays += 1
                if sync:
                    stream.synchronize()
                if profiling:
                    seg_seconds.append(span[0].elapsed_time(span[1]) / 1e3)
            else:
                fn = self._fns[seg.sid]
                invals = [env[s] for s in seg.inputs]
                for pos in self.donated[seg.sid]:
                    del env[seg.inputs[pos]]
                shared = self._shared(env, seg)
                t_ready = time.perf_counter() - t_start
                outs = fn(invals, shared)
                inplace += fn.inplace_writes
                if timed:
                    marks.append((t_ready, time.perf_counter() - t_start))
                if profiling:
                    seg_seconds.append(time.perf_counter() - t_start
                                       - t_ready)
                st.eager_segments += 1
                for slot, v in zip(seg.outputs, outs):
                    env[slot] = v
                    nbytes[slot] = _nbytes(v)
                outs = v = None
            if timed:
                dispatched.append(time.perf_counter() - t_start)
            # a donated input's block may hold the segment's outputs
            for pos in self.donated[seg.sid]:
                slot = seg.inputs[pos]
                live[self._pe_of(slot[0])] -= nbytes[slot]
                released.add(slot)
                freed += 1
            for slot in seg.outputs:
                alloc(seg.device, nbytes[slot])
            if self.capture and not sync:
                # outputs are registered, producer is in flight: start
                # the copies its consumers on other devices will need
                issue_prefetch(seg.sid)
            # liveness-driven freeing: drop values whose last consuming
            # segment has now run (plus their copies on other devices)
            for src in {s[0] for s in seg.inputs}:
                if src not in refcount:
                    continue
                refcount[src] -= 1
                if refcount[src] != 0:
                    continue
                for key in copies_by_src.pop(src, ()):
                    nb = float(nbytes[key[0]])
                    live[key[1]] -= nb
                    inflight -= nb
                    freed += 1
                pe = self._pe_of(src)
                for slot in self._slots_by_producer.get(src, ()):
                    if slot in released:
                        continue
                    live[pe] -= nbytes[slot]
                    env.pop(slot, None)
                    freed += 1

        outs = []
        if self.capture:
            for s in self._streams:
                torch.cuda.current_stream(s.device).wait_stream(s)
            for slot in prog.out_slots:
                if slot is None:
                    outs.append(None)
                    continue
                v = self._static_out[slot]
                outs.append(v.clone())
                st.output_clone_bytes += _nbytes(v)
            # sync before reading the clock: the loop above only enqueued
            for c in currents:
                c.synchronize()
        else:
            outs = [None if slot is None else env[slot]
                    for slot in prog.out_slots]
        st.execute_seconds = time.perf_counter() - t_start
        st.dispatch_seconds = dispatched
        st.segment_seconds = seg_seconds
        if self.capture and timed:
            # the events completed with the synchronise above
            st.ready_seconds, st.done_seconds, st.transfer_wait_seconds = \
                [], [], []
            for seg, (pre, ready, done) in zip(sched.segments, marks):
                base = bases[self.devices[seg.device]]
                st.ready_seconds.append(base.elapsed_time(ready) / 1e3)
                st.done_seconds.append(base.elapsed_time(done) / 1e3)
                st.transfer_wait_seconds.append(
                    pre.elapsed_time(ready) / 1e3)
        else:
            st.ready_seconds = [m[0] for m in marks]
            st.done_seconds = [m[1] for m in marks]
            st.transfer_wait_seconds = [0.0] * len(marks)
        if not self.capture:
            st.inplace_writes = inplace
        st.donated_bytes = float(sum(
            nbytes[seg.inputs[pos]] for seg in sched.segments
            for pos in self.donated[seg.sid]))
        st.calls += 1
        st.freed_buffers = freed
        st.peak_live_bytes = [float(x) for x in peak]
        st.resident_bytes = [float(x) for x in resident]
        return tree_unflatten(prog.out_tree, outs)


def execute_compiled(prog: TracedProgram, assignment: np.ndarray | None,
                     devices: list | None, *args,
                     donate: bool = True,
                     static_argnums: tuple[int, ...] = (),
                     mode: str | None = None, **kwargs):
    """One-shot convenience: build a :class:`CompiledRuntime` and call it.
    Returns ``(result, runtime)`` so callers can read the stats or reuse
    the captured segments."""
    rt = CompiledRuntime(prog, assignment, devices, donate=donate,
                         static_argnums=static_argnums, mode=mode)
    return rt(*args, **kwargs), rt


__all__ = ["CompiledRuntime", "DEFAULT_TRANSFER_WINDOW_BYTES",
           "RuntimeStats", "execute_compiled", "resolve_runtime_mode"]
