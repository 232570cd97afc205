"""Compiled segment runtime: executes a placed program as CUDA graphs
(the port's side of the reference's ``repro/core/runtime.py``).

Where ``core.executor.execute`` replays the traced program one aten call
at a time (the reference the runtime is held to), this runtime lowers
the placement into per-PE subprograms with explicit transfers:

* Each :class:`~repro_torch.core.segments.Segment` becomes one CUDA
  graph, captured once on its PE's ``torch.cuda.Stream`` and replayed on
  every later call. The reference compiles each segment ahead of time
  with ``jax.jit``; here the first call runs every segment eagerly on
  its PE's stream as a warm-up (cuBLAS handles and workspaces), then
  captures the segments in schedule order. Warm-up and capture time go
  into ``compile_seconds``, apart from run time.
* Each PE has its own graph memory pool, so that a PE's segments share
  memory as one device's executables do. During capture, a value's
  Python reference is dropped after its last consuming segment (the
  refcounts derived from the trace-time liveness table), and a later
  segment captured into the same pool reuses the memory.
* **Reads across pools.** Captured graphs have no ``record_stream``.
  When the last value that lies in a block of PE a's pool is dropped, a
  later capture on PE a may reuse the block while a reader on another
  PE's stream still runs at replay. The rule is kept per storage, not
  per node: a view taken on PE b of a tensor in PE a's pool keeps PE
  a's block alive, and the block goes back to PE a's pool only when the
  last of its aliases drops (:class:`_PoolOwners`). Then the first
  segment captured on PE a waits, at every replay, on the event recorded
  after the last segment on each other PE that read or made any of
  those aliases (``RuntimeStats.reuse_waits`` counts these waits).
  Holding such values until capture ends instead kept 17.9 GiB out of
  reuse (full granite-8b's decode step at K=4, folded onto one H100).
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
* **Donation.** ``jax.jit`` donation has no counterpart in PyTorch.
  ``donate`` is accepted for parity with the reference and changes
  nothing: a dead input's memory goes back to its PE's pool when its
  last reference drops, and a transferred copy lives until its source's
  last consuming segment (the reference frees a donated copy at its last
  reader on that device).
* **CPU.** With CPU devices (the tests) the segments run as plain
  Python replays in schedule order: no streams, no capture. That is the
  runtime's plain version. With CUDA devices it always captures, and a
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
do; the tests hold the runtime to the interpreter and to the eager step
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
    # event waits added so that no PE reuses memory that another PE's
    # stream may still read (the cross-pool rule)
    reuse_waits: int = 0
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


class _PoolOwners:
    """During capture: which PE's graph pool holds each storage that a
    segment's output lies in, which live slots alias it, and the last
    segment on each PE that read or made one of those slots.

    A storage first seen as an output of a segment captured on PE p was
    allocated from p's pool; a later output that lies in it (a view, on
    any PE) joins its aliases. The block goes back to p's pool when the
    last alias drops: :meth:`dropped` then returns p and the segments on
    other PEs that p's next capture must wait for. Storages the runtime
    holds for the whole call (inputs, constants, copy buffers) are
    pinned and never returned."""

    def __init__(self):
        self._owner: dict[int, int | None] = {}      # storage -> pe
        self._aliases: dict[int, set[Slot]] = {}     # storage -> live slots
        self._touched: dict[int, dict[int, int]] = {}  # storage -> pe -> sid
        self._storage: dict[Slot, int] = {}

    @staticmethod
    def _key(v: Any) -> int | None:
        if not isinstance(v, torch.Tensor):
            return None
        storage = v.untyped_storage()
        return storage.data_ptr() if storage.nbytes() else None

    def pin(self, v: Any) -> None:
        key = self._key(v)
        if key is not None:
            self._owner[key] = None

    def produced(self, slot: Slot, v: Any, pe: int, sid: int) -> None:
        key = self._key(v)
        if key is None:
            return
        self._owner.setdefault(key, pe)
        if self._owner[key] is None:
            return
        self._aliases.setdefault(key, set()).add(slot)
        self._storage[slot] = key
        self.read(slot, pe, sid)

    def read(self, slot: Slot, pe: int, sid: int) -> None:
        key = self._storage.get(slot)
        if key is not None:
            touched = self._touched.setdefault(key, {})
            touched[pe] = max(touched.get(pe, -1), sid)

    def dropped(self, slot: Slot) -> tuple[int, set[int]] | None:
        """``slot`` is dropped: when it was the last alias of its
        storage, (the owning pe, the segments on other PEs to wait for),
        else None."""
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
        return owner, {sid for pe, sid in touched.items() if pe != owner}


def _make_segment_fn(prog: TracedProgram, seg: Segment, device):
    """The Python callable replaying ``seg``'s nodes on ``device``; the
    segment's CUDA graph is a capture of one call of it. A node's value
    is dropped after its last reader inside the segment unless the
    segment exports it, so that a long segment (the whole step at K=1)
    holds no more than the eager step does."""
    kwargs = {nid: node_kwargs(prog.program[nid][1], device)
              for nid in seg.nodes}
    exported = {src for src, _ in seg.outputs}
    last_read: dict[int, int] = {}
    for nid in seg.nodes:
        for inp in prog.program[nid][2]:
            if inp[0] == "slot":
                last_read[inp[1]] = nid
    free_after: dict[int, list[int]] = {}
    for src, nid in last_read.items():
        if src in kwargs and src not in exported:
            free_after.setdefault(nid, []).append(src)

    def fn(*invals):
        env: dict[Slot, Any] = dict(zip(seg.inputs, invals))
        local: dict[int, Any] = {}

        def read(src: int, idx: int):
            if src in local:
                v = local[src]
                return v[idx] if isinstance(v, (tuple, list)) else v
            return env[(src, idx)]

        nid = -1
        try:
            for nid in seg.nodes:
                vals = [inp[1] if inp[0] == "lit" else read(inp[1], inp[2])
                        for inp in prog.program[nid][2]]
                local[nid] = run_node(prog, nid, vals, kwargs[nid])
                del vals
                for src in free_after.get(nid, ()):
                    del local[src]
        except RuntimeError as e:
            raise RuntimeError(
                f"segment {seg.sid} (pe {seg.device}), node {nid} "
                f"({prog.program[nid][0]}): {e}") from e
        return tuple(read(src, idx) for src, idx in seg.outputs)

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
        donate: accepted for parity with the reference; PyTorch has no
            donation, and the runtime frees by liveness alone.
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
        self._fns = [_make_segment_fn(prog, seg, devices[seg.device])
                     for seg in sched.segments]
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
        # capture state (CUDA): streams, events and pools per PE, the
        # graphs, the tensors they read and write
        self._graphs: list | None = None
        self._streams: list = []
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
        on its PE's stream, then one capture per segment in schedule
        order."""
        t0 = time.perf_counter()
        self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
        self._events = [torch.cuda.Event() for _ in self.schedule.segments]
        self._pools = [torch.cuda.graph_pool_handle() for _ in self.devices]
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
        self._graphs = []
        env = self._sweep(node_vals, capture=True)
        self._static_out = {slot: env[slot] for slot in self.prog.out_slots
                            if slot is not None}
        self._synchronize()
        self.stats.compile_seconds += time.perf_counter() - t0

    def _sweep(self, node_vals: dict, *, capture: bool) -> dict:
        """Every segment in schedule order on its PE's stream: run
        eagerly and synchronised (the warm-up), or captured into its
        graph. Values are dropped after their last consuming segment;
        while capturing, the drop of the last value in a block of a PE's
        pool adds the cross-pool waits. Returns the environment left at
        the end (the program's outputs)."""
        sched = self.schedule
        env: dict[Slot, Any] = {slot: node_vals[slot[0]]
                                for slot in self._root_slots}
        refcount = dict(sched.node_refcount)
        copies: dict[tuple[Slot, int], torch.Tensor] = {}
        owners = _PoolOwners()
        for v in env.values():
            owners.pin(v)
        # per PE: segments on other PEs that read memory dropped from its
        # pool, which its next captured segment must wait for
        pending: list[set[int]] = [set() for _ in self.devices]
        for seg in sched.segments:
            dev, stream = self.devices[seg.device], self._streams[seg.device]
            if capture and pending[seg.device]:
                new = pending[seg.device] - set(self._waits[seg.sid])
                self._waits[seg.sid] = tuple(sorted(
                    new.union(self._waits[seg.sid])))
                self.stats.reuse_waits += len(new)
                pending[seg.device] = set()
            invals = []
            for slot in seg.inputs:
                v = env[slot]
                owners.read(slot, seg.device, seg.sid)
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
            if capture:
                outs = self._capture(seg, stream, invals)
            else:
                with torch.cuda.stream(stream):
                    outs = self._fns[seg.sid](*invals)
                stream.synchronize()
            for slot, v in zip(seg.outputs, outs):
                env[slot] = v
                self._slot_bytes[slot] = _nbytes(v)
                owners.produced(slot, v, seg.device, seg.sid)
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
                    env.pop(slot, None)
                    freed = owners.dropped(slot)
                    if freed is not None:
                        pending[freed[0]].update(freed[1])
        return env

    def _capture(self, seg: Segment, stream, invals: list) -> tuple:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), warnings.catch_warnings():
            # a segment of views alone launches nothing: an empty graph
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
            graph.capture_begin(pool=self._pools[seg.device])
            try:
                outs = self._fns[seg.sid](*invals)
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
                t_ready = time.perf_counter() - t_start
                outs = self._fns[seg.sid](*[env[s] for s in seg.inputs])
                if timed:
                    marks.append((t_ready, time.perf_counter() - t_start))
                if profiling:
                    seg_seconds.append(time.perf_counter() - t_start
                                       - t_ready)
                st.eager_segments += 1
                for slot, v in zip(seg.outputs, outs):
                    env[slot] = v
                    nbytes[slot] = _nbytes(v)
            if timed:
                dispatched.append(time.perf_counter() - t_start)
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
        st.calls += 1
        st.freed_buffers = freed
        st.peak_live_bytes = [float(x) for x in peak]
        st.resident_bytes = [float(x) for x in resident]
        return tree_unflatten(prog.out_tree, outs)


def execute_compiled(prog: TracedProgram, assignment: np.ndarray | None,
                     devices: list | None, *args,
                     static_argnums: tuple[int, ...] = (),
                     mode: str | None = None, **kwargs):
    """One-shot convenience: build a :class:`CompiledRuntime` and call it.
    Returns ``(result, runtime)`` so callers can read the stats or reuse
    the captured segments."""
    rt = CompiledRuntime(prog, assignment, devices,
                         static_argnums=static_argnums, mode=mode)
    return rt(*args, **kwargs), rt


__all__ = ["CompiledRuntime", "DEFAULT_TRANSFER_WINDOW_BYTES",
           "RuntimeStats", "execute_compiled", "resolve_runtime_mode"]
