"""Cut a placed :class:`~repro_torch.core.executor.TracedProgram` into
maximal same-device dataflow segments.

A copy of the reference's ``repro/core/segments.py`` (numpy only): the
cut reads the program's structure (slots, liveness, placement) and
nothing of its ops, so both packages cut the same program into the same
schedule.

The op-by-op interpreter realizes a placement one primitive bind at a
time; related systems (Tofu, Tarnawski et al.) instead execute *compiled
per-device subprograms* with explicit cross-device transfers. This
module produces that shape:

1. **Device-affine topological order.** Kahn's algorithm over the
   recorded program, but the ready pool is bucketed per device and the
   sweep keeps draining the current device's ready nodes (smallest id
   first) before switching — so nodes of one cluster coalesce into long
   runs even when the raw id order interleaves devices. The order is
   deterministic (pure function of program + assignment) and, within a
   device, ascending in node id.
2. **Run cutting.** Consecutive same-device nodes of that order form one
   :class:`Segment`. Because segments are cut from a single linear
   topological order, segment dataflow only points backwards — the
   segment schedule is acyclic by construction and executable in order.
3. **Boundary slots.** Values crossing a segment boundary are tracked at
   slot granularity ``(node, out_idx)``: each segment lists the external
   slots it consumes (producer outside the segment — an earlier segment,
   a graph input, or a constant) and the slots it must export (consumed
   by a later segment or part of the program output). A consumed slot
   whose producer sits on a different device is a *transfer*: the
   runtime materializes it as an explicit copy (an event-ordered read
   when the PEs share a device).

The cut also precomputes everything the runtime's liveness machinery
needs statically: per-producer segment-level refcounts (how many
segments read a node, +1 when it feeds the program output) and, per
segment, which input slots die there (``dead_inputs`` — the reference's
jit donation set, which the verifier replays).

For the async runtime the cut additionally emits a **prefetch table**:
for every producing segment, the ``(slot, dst_pe)`` transfers whose
consumers live on another device. The runtime issues those copies the
moment the producer segment has been *dispatched* (not completed), so
the copy overlaps with compute instead of stalling the consumer.
Entries keyed ``-1`` belong to graph inputs/constants and are issued at
call start.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .errors import RP104_DEVICE_MISMATCH, PlanValidationError
from .executor import TracedProgram

Slot = tuple[int, int]


@dataclass(frozen=True)
class Segment:
    """One compiled unit: a maximal same-device run of program nodes."""
    sid: int
    device: int                     # pe index (0 when unplaced)
    nodes: tuple[int, ...]          # topological order within the segment
    inputs: tuple[Slot, ...]        # external slots read (deduped, ordered)
    outputs: tuple[Slot, ...]       # slots exported to later segments/output
    # input positions the reference donates to XLA: a cross-device copy
    # whose last reader on this device is this segment, or a same-device
    # intermediate whose last reader overall is this segment
    dead_inputs: tuple[int, ...] = ()
    # input positions whose producer lives on another device (transfers)
    transfer_inputs: tuple[int, ...] = ()


@dataclass
class SegmentSchedule:
    """The executable segment program: segments in dependency order plus
    the static liveness/refcount tables the runtime consumes."""
    segments: list[Segment]
    k: int                               # number of devices referenced
    # producer node -> number of consuming segments (+1 if program output)
    node_refcount: dict[int, int] = field(default_factory=dict)
    # producer node -> last consuming segment id (-1: only program output)
    last_consumer_seg: dict[int, int] = field(default_factory=dict)
    num_transfer_edges: int = 0          # static cross-device slot reads
    # producing segment id -> transfers to issue right after its dispatch
    # (-1: transfers of graph inputs/consts, issued at call start); one
    # entry per (slot, dst pe), ordered by first consumer
    prefetch: dict[int, tuple[tuple[Slot, int], ...]] = \
        field(default_factory=dict)
    # (slot, consuming pe) -> last consuming segment on that pe — the
    # only segment allowed to donate the cached transferred copy
    last_reader_on_dev: dict[tuple[Slot, int], int] = \
        field(default_factory=dict)
    # slot -> producing segment id (-1 for graph inputs/consts)
    producer_seg: dict[Slot, int] = field(default_factory=dict)

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def segments_per_device(self) -> list[int]:
        out = [0] * max(self.k, 1)
        for s in self.segments:
            out[s.device] += 1
        return out


def device_topo_order(prog: TracedProgram,
                      assignment: np.ndarray | None) -> list[int]:
    """Device-affine topological order of the program nodes (step 1)."""
    nodes = sorted(prog.program)
    node_set = set(nodes)
    if assignment is None:
        return nodes

    dev = {nid: int(assignment[nid]) for nid in nodes}
    consumers, _ = prog.liveness()
    indeg = {nid: 0 for nid in nodes}
    for nid in nodes:
        _, _, inputs = prog.program[nid]
        indeg[nid] = sum(1 for inp in inputs
                         if inp[0] == "slot" and inp[1] in node_set)

    ready: dict[int, list[int]] = {}
    for nid in nodes:
        if indeg[nid] == 0:
            heapq.heappush(ready.setdefault(dev[nid], []), nid)

    order: list[int] = []
    cur = -1
    while len(order) < len(nodes):
        bucket = ready.get(cur)
        if not bucket:
            # switch to the device holding the globally smallest ready id
            cur = min((h[0], d) for d, h in ready.items() if h)[1]
            bucket = ready[cur]
        nid = heapq.heappop(bucket)
        order.append(nid)
        for c in consumers.get(nid, ()):
            if c in indeg:
                # indeg counted one per slot-input; decrement likewise
                refs = sum(1 for inp in prog.program[c][2]
                           if inp[0] == "slot" and inp[1] == nid)
                indeg[c] -= refs
                if indeg[c] == 0:
                    heapq.heappush(ready.setdefault(dev[c], []), c)
    return order


def cut_segments(prog: TracedProgram, assignment: np.ndarray | None,
                 k: int | None = None) -> SegmentSchedule:
    """Cut the placed program into the executable segment schedule.

    ``assignment`` maps node id -> pe (None: single device 0). ``k``
    bounds the pe indices actually used; it is validated against the
    assignment so a plan with more PEs than devices fails loudly here
    rather than aliasing silently.
    """
    nodes_order = device_topo_order(prog, assignment)
    node_set = set(nodes_order)

    def dev(nid: int) -> int:
        return 0 if assignment is None else int(assignment[nid])

    used_k = 1 + max((dev(n) for n in nodes_order), default=0)
    for nid in list(prog.input_nodes) + [n for n, _ in prog.const_nodes]:
        used_k = max(used_k, dev(nid) + 1)
    if k is not None and used_k > k:
        raise PlanValidationError(
            f"placement uses {used_k} PEs but the runtime was given "
            f"{k} devices — pass an explicit device_map or more devices",
            code=RP104_DEVICE_MISMATCH)
    k = used_k if k is None else k

    # --- run cutting -------------------------------------------------------
    runs: list[list[int]] = []
    for nid in nodes_order:
        if runs and dev(runs[-1][-1]) == dev(nid):
            runs[-1].append(nid)
        else:
            runs.append([nid])

    seg_of_node: dict[int, int] = {}
    for sid, run in enumerate(runs):
        for nid in run:
            seg_of_node[nid] = sid

    consumers, output_nodes = prog.liveness()

    # --- per-producer segment-level liveness -------------------------------
    # consuming segments per producer node (graph inputs/consts included)
    cons_segs: dict[int, set[int]] = {}
    for sid, run in enumerate(runs):
        for nid in run:
            for inp in prog.program[nid][2]:
                if inp[0] != "slot":
                    continue
                src = inp[1]
                if seg_of_node.get(src) != sid:
                    cons_segs.setdefault(src, set()).add(sid)
    node_refcount = {p: len(s) for p, s in cons_segs.items()}
    last_seg = {p: max(s) for p, s in cons_segs.items()}
    for p in output_nodes:
        node_refcount[p] = node_refcount.get(p, 0) + 1
        last_seg.setdefault(p, -1)

    # --- boundary slots (pass 1) -------------------------------------------
    out_slot_set = {s for s in prog.out_slots if s is not None}
    seg_inputs: list[list[Slot]] = []
    seg_outputs: list[list[Slot]] = []
    # (slot, consuming pe) -> last consuming segment on that pe: the
    # runtime caches one transferred copy per target device and only the
    # final reader there may donate it
    last_on_dev: dict[tuple[Slot, int], int] = {}
    for sid, run in enumerate(runs):
        run_set = set(run)
        sdev = dev(run[0])
        in_slots: list[Slot] = []
        seen: set[Slot] = set()
        for nid in run:
            for inp in prog.program[nid][2]:
                if inp[0] != "slot":
                    continue
                src, idx = inp[1], inp[2]
                if src in run_set:
                    continue
                slot = (src, idx)
                if slot not in seen:
                    seen.add(slot)
                    in_slots.append(slot)
                    last_on_dev[(slot, sdev)] = sid
        out_slots: list[Slot] = []
        for nid in run:
            n_out = prog.n_outputs.get(nid, 1)
            for idx in range(n_out):
                slot = (nid, idx)
                exported = slot in out_slot_set
                if not exported:
                    for c in consumers.get(nid, ()):
                        if seg_of_node.get(c) != sid and any(
                                inp[0] == "slot" and inp[1] == nid
                                and inp[2] == idx
                                for inp in prog.program[c][2]):
                            exported = True
                            break
                if exported:
                    out_slots.append(slot)
        seg_inputs.append(in_slots)
        seg_outputs.append(out_slots)

    # --- donation/transfer sets + prefetch table (pass 2) ------------------
    segments: list[Segment] = []
    num_transfers = 0
    prefetch: dict[int, list[tuple[Slot, int]]] = {}
    prefetched: set[tuple[Slot, int]] = set()
    for sid, run in enumerate(runs):
        sdev = dev(run[0])
        dead: list[int] = []
        transfers: list[int] = []
        for pos, slot in enumerate(seg_inputs[sid]):
            src = slot[0]
            if dev(src) != sdev:
                # cross-pe read: the runtime materializes (and caches)
                # one copy per target device; the reference donates it
                # at its LAST reader on this device — PROVIDED the pes
                # map to distinct physical devices (an aliased
                # device_map makes the read a no-copy alias)
                transfers.append(pos)
                num_transfers += 1
                if last_on_dev[(slot, sdev)] == sid:
                    dead.append(pos)
                # the copy is issued once per (slot, target device) —
                # register it for prefetch at its producer's dispatch
                if (slot, sdev) not in prefetched:
                    prefetched.add((slot, sdev))
                    psid = seg_of_node.get(src, -1)
                    prefetch.setdefault(psid, []).append((slot, sdev))
            elif (src in node_set and src not in output_nodes
                    and last_seg.get(src) == sid):
                # same-device intermediate whose last reader is this
                # segment — freed right after, safe to donate
                dead.append(pos)
        segments.append(Segment(
            sid=sid, device=sdev, nodes=tuple(run),
            inputs=tuple(seg_inputs[sid]), outputs=tuple(seg_outputs[sid]),
            dead_inputs=tuple(dead), transfer_inputs=tuple(transfers)))

    producer_seg: dict[Slot, int] = {}
    for seg in segments:
        for slot in seg.outputs:
            producer_seg[slot] = seg.sid
        for slot in seg.inputs:
            producer_seg.setdefault(slot, seg_of_node.get(slot[0], -1))

    return SegmentSchedule(segments=segments, k=k,
                           node_refcount=node_refcount,
                           last_consumer_seg=last_seg,
                           num_transfer_edges=num_transfers,
                           prefetch={s: tuple(v)
                                     for s, v in prefetch.items()},
                           last_reader_on_dev=dict(last_on_dev),
                           producer_seg=producer_seg)
