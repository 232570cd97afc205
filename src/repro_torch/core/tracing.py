"""aten FX graph → CostGraph tracing (+ recorded program).

The port's counterpart of the reference's jaxpr tracer
(``repro/core/tracing.py``). ``trace_cost_graph`` traces a PyTorch
function with ``make_fx`` over ``torch.func.functionalize`` into an
aten-level FX graph, and turns every aten call into a node of the
partitioner's ``CostGraph``, annotated as the reference annotates a
jaxpr equation:

  comp(n) — roofline seconds: max(FLOPs / peak·eff, bytes / HBM bw)
  mem(n)  — output bytes
  comm(e) — link latency + bytes / link bw

The rules that make the two graphs comparable:

* **Inputs.** The pytree of example arguments is flattened in JAX's leaf
  order (dict keys sorted, lists and tuples in order), and each leaf
  becomes one RESIDUAL ``param`` node; ``get_attr`` constants become
  RESIDUAL ``const`` nodes, created first, as the jaxpr's constvars are.
* **Pricing.** FLOPs follow the reference's rules (``_dot_flops``,
  ``_CHEAP_MULT``, ``_flops_of``); :data:`ATEN_PRIMS` names, for each
  aten op that is not priced as one elementwise pass, the primitives the
  reference's jaxpr spells it with.
* **Views** (:data:`VIEW_OPS`) stay nodes, so that the recorded program
  replays. They are priced as the reference prices its per-layer
  ``scan_slice``: ``comp = 0``, and ``mem`` = the bytes of the view's own
  output, so that a PE that reads a view from another PE is charged for
  the copy it holds. An edge into a view carries no more than the view
  (a layer's slice of a stacked weight, not the stack); every other edge
  carries the bytes of its source tensor.
* **Mutations** become functional ops through ``functionalize``: an
  in-place write into an input (the paged KV pools) makes the new value a
  node output, and the write-back ``copy_`` into the input that
  ``functionalize`` appends is dropped. Dead nodes are removed.
* **Multiple outputs.** ``operator.getitem`` is not an op: it maps to
  ``(producer, out_idx)``.
* **Recurrence.** The RWKV6 custom ops (:data:`RECURRENCE_OPS`) are one
  node each, priced by the chunked form's products (as the reference's
  jaxpr counts ``_wkv_chunked``, forward and gradient) plus one pass on
  their outputs.
* **Selective scan.** Mamba's custom ops (:data:`SCAN_OPS`) are one
  node each, priced as the reference's jaxpr counts ``_ssm_scan_chunked``
  (:func:`scan_flops`): the scan over chunks of C tokens (C = S // (S //
  chunk), ``chunk`` the op's argument), in each chunk the associative
  scan's slices, combines, concatenations and interleaving pads of its
  log2(C) levels, and around it the exponentials, products,
  broadcasts, reshapes, transposes and the einsum with C; the backward
  node as the reference's ``vjp`` of it less the forward. Written with
  E = B·S·d_inner·N, X = B·S·d_inner, Y = B·S·N, P = B·d_inner·N, n the
  chunk count, the levels' lengths n_k (C, C // 2, ... while >= 2;
  m_k = n_k // 2, k_k = m_k - [n_k even]), L1 = n·P·Σ n_k, Lc = n·P·#levels
  and SL = n·P·Σ (4m_k + 2k_k + 2k_k[n_k even] + 2):

    forward = 18E + 3X + Y + d_inner·N + n·P + 3n + 9L1 - 3Lc + SL
              + P [no h0]
    vjp     = 41E + 10X + 3Y + 3·d_inner·N + 6n·P + 34L1 - 10Lc + 2SL + 3
              + 3P [no h0] + (2X + Y + n·P) [B = 1]

  of which the products (dot_general) are 2E and 6E. The counts are the
  reference tracer's own, matched term by term on its traces (B = 1
  drops broadcasts of size-1 axes and adds reductions), for N >= 2.
* **Attention.** The port's flash-attention custom ops
  (:data:`ATTENTION_OPS`) are one node each, priced as the reference
  prices the same attention in the same step: its jaxpr differentiates
  the dense ``_plain_gqa``, so it counts 4·B·H·Sq·Sk·hd of products and
  the softmax forward, and 8·B·H·Sq·Sk·hd and one elementwise pass on
  the scores backward. Their ``mem`` is their outputs: unlike the
  reference's graph, no node holds the S² probabilities.
* **Collectives.** The custom ops of ``distributed.TracingMesh``
  (:data:`COLLECTIVE_OPS`: one rank's program traced with its
  collectives) are one node each with no FLOPs; the bytes they touch are
  their operand and their result.
* **Training steps** (``autograd=True``). ``functionalize`` refuses a
  function that makes leaves require grad, which a step differentiated
  with ``torch.autograd`` does; such a step is traced in two passes,
  first as it runs (autograd records the backward's aten ops), then
  that graph functionalized.

With ``record=True`` the tracer also returns a :class:`TracedProgram`:
every node's aten op, keyword arguments and positional inputs, as
``("slot", src_node, out_idx)`` or ``("lit", value)``.

The trace runs on fake tensors: it runs nothing. The graph and its
fingerprint depend on shapes and dtypes only: not on the device the
example tensors live on, and not on tensor addresses (a trace on real
tensors gives the same graph).
"""
from __future__ import annotations

import operator
from typing import Any, Callable

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from ..tree import tree_flatten, tree_unflatten
from .costmodel import H100, DeviceModel
from .executor import TracedProgram
from .graph import CostGraph, NORMAL, RESIDUAL

# env entry: fx.Node -> (node_id, out_idx)
Slot = tuple[int, int]


# ---------------------------------------------------------------------------
# pricing (the reference's rules, spelled for aten)
# ---------------------------------------------------------------------------
def _numel(t) -> float:
    return float(np.prod(tuple(t.shape), dtype=np.float64))


def _tensor_bytes(t) -> float:
    return _numel(t) * t.element_size()


def _dot_flops(a, b) -> float:
    """2 · batch · m · n · contract for ``a @ b`` of mm/bmm operands."""
    batch = float(np.prod(tuple(a.shape[:-2]), dtype=np.float64))
    m, contract = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    return 2.0 * batch * m * n * contract


#: aten op -> index of its two product operands among the positional args
DOT_OPS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2)}

_CHEAP_MULT = {
    "reduce_sum": 1.0, "reduce_max": 1.0, "reduce_min": 1.0,
    "cumsum": 1.0, "cumlogsumexp": 3.0, "argmax": 1.0, "argmin": 1.0,
    "exp": 4.0, "log": 4.0, "tanh": 4.0, "logistic": 4.0, "erf": 6.0,
    "rsqrt": 2.0, "sqrt": 2.0, "sort": 8.0, "top_k": 8.0,
    "integer_pow": 2.0, "pow": 6.0,
}

#: aten op -> the reference's primitives for it. A primitive is priced
#: on the op's output elements, except ``reduce_*`` and ``cumsum`` (on
#: its input elements, as the reference prices them) and a part marked
#: ``@in`` (an elementwise pass over the input of a reduction). Any op
#: not listed here, and not a product or a view, is one elementwise pass
#: on its output (multiplier 1), as the reference's default.
ATEN_PRIMS = {
    "exp": ("exp",), "log": ("log",), "tanh": ("tanh",),
    "sigmoid": ("logistic",), "erf": ("erf",), "rsqrt": ("rsqrt",),
    "sqrt": ("sqrt",),
    "sum": ("reduce_sum",), "amax": ("reduce_max",),
    "amin": ("reduce_min",), "mean": ("reduce_sum", "div"),
    "max": ("reduce_max",), "min": ("reduce_min",),
    "max.dim": ("reduce_max", "argmax"), "min.dim": ("reduce_min", "argmin"),
    "var": ("reduce_sum", "div", "sub@in", "integer_pow@in", "reduce_sum",
            "div"),
    "argmax": ("argmax",), "argmin": ("argmin",),
    "cumsum": ("cumsum",), "logcumsumexp": ("cumlogsumexp",),
    "sort": ("sort",), "topk": ("top_k",),
    "square": ("integer_pow",),
    # fused ops: the sum of their parts
    "silu": ("logistic", "mul"),
    "gelu": ("div", "erf", "add", "mul", "div"),
    "gelu.tanh": ("integer_pow", "mul", "add", "mul", "tanh", "add", "mul",
                  "mul"),
    "_softmax": ("reduce_max", "sub", "exp", "reduce_sum", "div"),
    "_log_softmax": ("reduce_max", "sub", "exp", "reduce_sum", "log", "sub"),
    "logsumexp": ("reduce_max", "sub@in", "exp@in", "reduce_sum", "log",
                  "add"),
}

#: view and alias ops: no compute; priced as the reference's slices
VIEW_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute", "t",
    "transpose", "expand", "slice", "select", "unsqueeze", "squeeze",
    "split", "split_with_sizes", "unbind", "alias", "as_strided", "detach",
    "diagonal", "unfold", "narrow", "view_as",
})


def op_name(op) -> str:
    """``mm``, ``pow.Tensor_Scalar``: the aten op without namespace and
    without its ``default`` overload."""
    name = op.overloadpacket.__name__
    over = op._overloadname
    return name if over == "default" else f"{name}.{over}"


def _prims_of(op, args, kwargs) -> tuple[str, ...]:
    name = op.overloadpacket.__name__
    if name == "pow":
        # x ** 2 is integer_pow in the reference; any other pow is pow
        e = args[1] if len(args) > 1 else None
        integer = isinstance(e, int) and not isinstance(e, bool)
        return ("integer_pow",) if integer else ("pow",)
    if name == "gelu" and kwargs.get("approximate", "none") == "tanh":
        return ATEN_PRIMS["gelu.tanh"]
    full = op_name(op)
    if full in ATEN_PRIMS:
        return ATEN_PRIMS[full]
    # max.other / min.other are elementwise, not the reductions
    if name in ATEN_PRIMS and name not in ("max", "min"):
        return ATEN_PRIMS[name]
    return (name,)


#: the port's attention custom ops -> (index of q and k among the
#: positional args, product FLOPs per (batch, head, query, key, head-dim
#: element), primitives priced on the B·H·Sq·Sk scores)
ATTENTION_OPS = {
    "flash_attention": (0, 1, 4, ATEN_PRIMS["_softmax"]),
    "flash_attention_bwd": (1, 2, 8, ("_softmax_backward_data",)),
}


#: the port's RWKV6 recurrence custom ops -> how many times the chunked
#: form's forward products each call does: per (batch, head, chunk of
#: C tokens), r̂k̂ᵀ and A v (C²·hd each), r̂ S_in and k_tailᵀ v (C·hd²
#: each); the backward twice as many, as the reference's jaxpr counts
#: ``_wkv_chunked`` and its gradient (the kernel itself recomputes the
#: states and A: ten products to the forward's four)
RECURRENCE_OPS = {"wkv6": 1, "wkv6_bwd": 2}

#: Mamba's selective-scan custom ops (the module docstring has the rule)
SCAN_OPS = ("selective_scan", "selective_scan_bwd")

#: the collective custom ops of ``distributed.TracingMesh`` -> the kind
#: the reference's ``collective_bytes_from_hlo`` names it by
COLLECTIVE_OPS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                  "reduce_scatter": "reduce-scatter"}


def _scan_levels(C: int) -> tuple[int, int, int]:
    """(Σ n_k, the number of levels, Σ slice elements per state) of the
    reference's associative scan over C elements (jax.lax's recursion:
    pairs combined, the odd half scanned, the even half combined, both
    interleaved by pads)."""
    total = count = slices = 0
    n = C
    while n >= 2:
        m = n // 2
        k = m - 1 if n % 2 == 0 else m
        total += n
        count += 1
        slices += 4 * m + 2 * k + (2 * k if n % 2 == 0 else 0) + 2
        n = m
    return total, count, slices


def scan_flops(B: int, S: int, di: int, N: int, chunk: int, h0: bool,
               backward: bool) -> tuple[float, float]:
    """(FLOPs, product FLOPs) of one selective-scan op at these sizes:
    the reference's count of ``_ssm_scan_chunked`` (forward), or of its
    vjp less that (backward)."""
    n = max(S // chunk, 1)
    E, X, Y = float(B) * S * di * N, float(B) * S * di, float(B) * S * N
    P = float(B) * di * N
    total, count, slices = _scan_levels(S // n)
    L1, Lc, SL = n * P * total, n * P * count, n * P * slices
    fwd = (18 * E + 3 * X + Y + di * N + n * P + 3 * n + 9 * L1 - 3 * Lc
           + SL + (0 if h0 else P))
    if not backward:
        return fwd, 2 * E
    vjp = (41 * E + 10 * X + 3 * Y + 3 * di * N + 6 * n * P + 34 * L1
           - 10 * Lc + 2 * SL + 3 + (0 if h0 else 3 * P)
           + (2 * X + Y + n * P if B == 1 else 0))
    return vjp - fwd, 4 * E


def _scan_op_flops(name, args) -> tuple[float, float]:
    """:func:`scan_flops` of a scan op's call: u, A and h0 are its
    first, fifth and sixth arguments, chunk its last."""
    B, S, di = args[0].meta["val"].shape
    N = args[4].meta["val"].shape[1]
    return scan_flops(B, S, di, N, args[-1], args[5] is not None,
                      name == "selective_scan_bwd")


def _recurrence_dot_flops(name, args) -> float:
    """Product FLOPs of a recurrence op's call: chunks of ``min(chunk,
    S)`` tokens, as the reference cuts S."""
    B, S, H, hd = args[0].meta["val"].shape
    chunk = args[-1]
    n, C = -(-S // chunk), min(chunk, S)
    fwd = 2.0 * B * H * n * (2 * C * C * hd + 2 * C * hd * hd)
    return RECURRENCE_OPS[name] * fwd


def _attention_sizes(name, args) -> tuple[float, float]:
    """(score elements B·H·Sq·Sk, head dim) of an attention op's call."""
    iq, ik = ATTENTION_OPS[name][:2]
    B, Sq, H, hd = args[iq].meta["val"].shape
    Sk = args[ik].meta["val"].shape[1]
    return float(B) * H * Sq * Sk, float(hd)


def dot_flops_of(op, args) -> float:
    """The matrix-product FLOPs of one aten call (0 for anything but
    the mm-class ops and the attention ops)."""
    name = op.overloadpacket.__name__
    if name in DOT_OPS:
        i, j = DOT_OPS[name]
        return _dot_flops(args[i].meta["val"], args[j].meta["val"])
    if name in ATTENTION_OPS:
        scores, hd = _attention_sizes(name, args)
        return ATTENTION_OPS[name][2] * scores * hd
    if name in RECURRENCE_OPS:
        return _recurrence_dot_flops(name, args)
    if name in SCAN_OPS:
        return _scan_op_flops(name, args)[1]
    return 0.0


def flops_of(op, args, kwargs, in_vals, out_vals) -> float:
    """FLOPs of one aten call under the reference's rules."""
    name = op.overloadpacket.__name__
    if name in DOT_OPS:
        return dot_flops_of(op, args)
    if name in ATTENTION_OPS:
        scores, _ = _attention_sizes(name, args)
        return dot_flops_of(op, args) + scores * sum(
            _CHEAP_MULT.get(prim, 1.0) for prim in ATTENTION_OPS[name][3])
    if name in SCAN_OPS:
        return _scan_op_flops(name, args)[0]
    if name in COLLECTIVE_OPS:
        return 0.0
    out_elems = sum(_numel(v) for v in out_vals)
    if name in RECURRENCE_OPS:
        return dot_flops_of(op, args) + out_elems
    in_elems = sum(_numel(v) for v in in_vals)
    total = 0.0
    for prim in _prims_of(op, args, kwargs):
        prim, _, basis = prim.partition("@")
        mult = _CHEAP_MULT.get(prim, 1.0)
        on_input = basis == "in" or prim.startswith("reduce") \
            or prim == "cumsum"
        total += (in_elems if on_input else out_elems) * mult
    return total


def _out_vals(node) -> tuple[list, int]:
    """The tensors an op returns, and its number of outputs."""
    val = node.meta["val"]
    if isinstance(val, (list, tuple)):
        return [v for v in val if isinstance(v, torch.Tensor)], len(val)
    return [val], 1


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------
class _Tracer:
    def __init__(self, dev: DeviceModel, record: bool):
        self.g = CostGraph()
        self.dev = dev
        self.record = record
        # per-node physical annotations, parallel to g.comp
        self.op_flops: list[float] = []
        self.op_bytes: list[float] = []
        self.op_dot_flops: list[float] = []
        self.program: dict[int, tuple] = {}
        self.n_outputs: dict[int, int] = {}
        self.arg_specs: dict[int, Any] = {}

    def _node(self, comp: float, mem: float, ntype: int, name: str,
              flops: float = 0.0, bytes_touched: float = 0.0,
              dot_flops: float = 0.0) -> int:
        nid = self.g.add_node(comp=comp, mem=mem, ntype=ntype, name=name)
        self.op_flops.append(float(flops))
        self.op_bytes.append(float(bytes_touched))
        self.op_dot_flops.append(float(dot_flops))
        return nid

    def _edge(self, src: int, dst: int, nbytes: float) -> None:
        self.g.add_edge(src, dst, comm=self.dev.comm_seconds(nbytes))

    def op(self, node, env: dict) -> None:
        op, args, kwargs = node.target, node.args, node.kwargs
        if any(isinstance(v, torch.fx.Node)
               for v in pytree.tree_leaves(kwargs)):
            raise NotImplementedError(
                f"{op}: a tensor passed by keyword is not supported")
        leaves, spec = pytree.tree_flatten(args)
        in_vals = [a.meta["val"] for a in leaves
                   if isinstance(a, torch.fx.Node)]
        out_vals, n_out = _out_vals(node)
        name = op_name(op)
        mem = sum(_tensor_bytes(v) for v in out_vals)
        is_view = op.overloadpacket.__name__ in VIEW_OPS
        if is_view:
            comp = flops = touched = dot = 0.0
        else:
            touched = sum(_tensor_bytes(v) for v in in_vals) + mem
            flops = flops_of(op, args, kwargs, in_vals, out_vals)
            dot = dot_flops_of(op, args)
            comp = self.dev.compute_seconds(flops, touched)
        nid = self._node(comp=comp, mem=mem, ntype=NORMAL, name=name,
                         flops=flops, bytes_touched=touched, dot_flops=dot)
        seen: set[int] = set()
        inputs = []
        for a in leaves:
            if not isinstance(a, torch.fx.Node):
                inputs.append(("lit", a))
                continue
            src, idx = env[a]
            inputs.append(("slot", src, idx))
            if src not in seen:
                seen.add(src)
                nbytes = _tensor_bytes(a.meta["val"])
                self._edge(src, nid, min(nbytes, mem) if is_view else nbytes)
        env[node] = (nid, 0)
        if self.record:
            self.program[nid] = (op, dict(kwargs), inputs)
            self.arg_specs[nid] = spec
            self.n_outputs[nid] = n_out


def _functional_graph(fn: Callable, example_args: tuple,
                      tracing_mode: str = "fake", autograd: bool = False):
    """``fn`` as an aten FX graph over the flat input leaves, with the
    input write-backs dropped and dead nodes removed. Returns the graph
    module and the output structure. ``tracing_mode="real"`` runs ``fn``
    once; it exists to check that it gives the fake trace's graph.
    ``autograd=True`` traces ``fn`` as it runs first (it may call
    ``torch.autograd``), then functionalizes that graph."""
    leaves, in_structure = tree_flatten(example_args)
    bad = [type(x).__name__ for x in leaves if not isinstance(x, torch.Tensor)]
    if bad:
        raise TypeError(f"every input leaf must be a tensor, got {bad}")
    out_structure: list = []

    def flat_fn(*flat):
        out = fn(*tree_unflatten(in_structure, flat))
        out_leaves, structure = tree_flatten(out)
        out_structure[:] = [structure]
        return out_leaves

    # tensors ``fn`` closes over become constants (get_attr), as a
    # jaxpr's constvars do, in fake mode as well
    if autograd:
        flat_fn = make_fx(flat_fn, tracing_mode=tracing_mode,
                          _allow_non_fake_inputs=True)(*leaves)
    func = torch.func.functionalize(flat_fn, remove="mutations")
    gm = make_fx(lambda *flat: func(*flat), tracing_mode=tracing_mode,
                 _allow_non_fake_inputs=True)(*leaves)
    graph = gm.graph
    for node in list(graph.nodes):
        if (node.op == "call_function"
                and node.target is torch.ops.aten.copy_.default
                and node.args[0].op == "placeholder" and not node.users):
            graph.erase_node(node)
    graph.eliminate_dead_code()
    return gm, out_structure[0]


def _get_attr(gm, target: str):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def trace_cost_graph(fn: Callable, *example_args,
                     dev: DeviceModel = H100,
                     params_residual: bool = True,
                     record: bool = False, autograd: bool = False):
    """Trace ``fn(*example_args)`` into a cost graph.

    ``example_args`` is a pytree (dicts, lists, tuples) of tensors. Its
    leaves become RESIDUAL nodes (parameters and step inputs — memory
    that survives the step, the paper's res_ns), numbered in JAX's leaf
    order after the constants. ``autograd=True`` is for a function that
    differentiates with ``torch.autograd`` (a training step): the
    backward's ops become nodes of the graph.

    Returns the CostGraph, or ``(CostGraph, TracedProgram)`` when
    ``record=True``.
    """
    gm, out_structure = _functional_graph(fn, example_args,
                                          autograd=autograd)
    return _cost_graph(gm, out_structure, example_args, dev=dev,
                       params_residual=params_residual, record=record)


def _cost_graph(gm, out_structure, example_args: tuple, *,
                dev: DeviceModel, params_residual: bool, record: bool):
    """The cost graph (and program) of a graph from
    :func:`_functional_graph`."""
    tr = _Tracer(dev, record)
    env: dict = {}
    const_nodes: list[tuple[int, Any]] = []
    for node in gm.graph.nodes:
        if node.op == "get_attr":
            val = _get_attr(gm, node.target)
            nid = tr._node(comp=0.0, mem=_tensor_bytes(val),
                           ntype=RESIDUAL, name="const")
            env[node] = (nid, 0)
            const_nodes.append((nid, val))
    input_nodes: list[int] = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            nid = tr._node(
                comp=0.0, mem=_tensor_bytes(node.meta["val"]),
                ntype=RESIDUAL if params_residual else NORMAL, name="param")
            env[node] = (nid, 0)
            input_nodes.append(nid)
    out_slots: list[Slot | None] = []
    for node in gm.graph.nodes:
        if node.op == "call_function":
            if node.target is operator.getitem:
                src, idx = node.args
                env[node] = (env[src][0], int(idx))
            else:
                tr.op(node, env)
        elif node.op == "output":
            out_slots = [env.get(v) if isinstance(v, torch.fx.Node)
                         else None for v in node.args[0]]
        elif node.op not in ("placeholder", "get_attr"):
            raise NotImplementedError(f"fx node kind {node.op!r}")
    g = tr.g.finalize()
    g.op_flops = np.asarray(tr.op_flops, dtype=np.float64)
    g.op_bytes = np.asarray(tr.op_bytes, dtype=np.float64)
    g.op_dot_flops = np.asarray(tr.op_dot_flops, dtype=np.float64)
    if not record:
        return g
    prog = TracedProgram(program=tr.program, n_outputs=tr.n_outputs,
                         input_nodes=input_nodes, const_nodes=const_nodes,
                         out_slots=out_slots, out_tree=out_structure,
                         in_tree_example=(example_args, {}),
                         arg_specs=tr.arg_specs)
    # the liveness/last-consumer table, computed once at trace time
    prog.liveness()
    return g, prog


__all__ = ["ATEN_PRIMS", "ATTENTION_OPS", "COLLECTIVE_OPS", "DOT_OPS",
           "RECURRENCE_OPS",
           "SCAN_OPS", "VIEW_OPS", "dot_flops_of", "flops_of", "op_name",
           "scan_flops", "trace_cost_graph"]
