"""The port's tracer against the JAX reference's, on the paged decode step
of reduced granite-8b at the serving geometry, with bridged weights:
the same input leaves in the same order, the same matmul FLOPs and
logits bytes, a deterministic acyclic graph, the reference's partitioner
giving the same assignment on the port's graph, and a recorded program
that replays to the eager step's outputs bit for bit. The cached step of
granite-8b and deepseek-v2-lite-16b at 3 and 6 layers has the
reference's shape: each layer's cache write a per-index value of one
stack (no whole-stack ``select_scatter``), no more whole-size nodes than
the reference's, a one-PE peak within 1.10x of its at 6 layers, and a
bit-equal replay."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from jax import lax  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import repro  # noqa: E402
import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.serving as js  # noqa: E402
from repro.core import costmodel as jcost  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import partitioner as jpart  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.serving as ts  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import tracing as ttracing  # noqa: E402
from repro_torch.core.costmodel import H100  # noqa: E402
from repro_torch.core.emulator import emulate  # noqa: E402
from repro_torch.core.graph import RESIDUAL  # noqa: E402
from repro_torch.core.memops import compute_profile  # noqa: E402
from repro_torch.core.tracing import DOT_OPS  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_map,  # noqa: E402
                              tree_unflatten)

GEOMETRY = js.serving_geometry()
assert GEOMETRY == ts.serving_geometry()
# the reference traced with the port's device model, so that both
# graphs price compute and links alike
H100_REF = jcost.DeviceModel(**dataclasses.asdict(H100))


def _trace_both(arch: str, layers):
    """Both packages' traces of the paged decode step of reduced ``arch``
    (float32, bridged weights), plus what built them."""
    jc = jcfg.reduced(jcfg.get_config(arch), layers=layers)
    tc = tcfg.reduced(tcfg.get_config(arch), layers=layers)
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jeng = js.ServingEngine(jc, jp, jit=False, **GEOMETRY)
    jt = repro.trace(jeng._decode_impl, *jeng._decode_example_args(),
                     record=True, dev=H100_REF)
    teng = ts.ServingEngine(tc, tp, device="cpu", **GEOMETRY)
    tt = tapi.trace(teng._decode_impl, *teng._decode_example_args(),
                    record=True)
    return dict(layers=layers, tc=tc, tp=tp, teng=teng, jt=jt, tt=tt)


@pytest.fixture(scope="module", params=[None, 3], ids=["reduced", "layers3"])
def traced(request):
    """Both packages' traces of granite-8b's paged decode step."""
    return _trace_both("granite-8b", request.param)


#: (arch, layers) of the cached steps held to the reference's shape
CACHED = [("granite-8b", 3), ("granite-8b", 6),
          ("deepseek-v2-lite-16b", 3), ("deepseek-v2-lite-16b", 6)]


@pytest.fixture(scope="module", params=CACHED,
                ids=[f"{a}-{n}" for a, n in CACHED])
def cached(request):
    return _trace_both(*request.param)


def test_input_leaves_match_reference_in_order(traced):
    jt, tt = traced["jt"], traced["tt"]
    jin, tin = jt.program.input_nodes, tt.program.input_nodes
    assert len(tin) == len(jin) > 10
    assert [float(tt.graph.mem[i]) for i in tin] == \
        [float(jt.graph.mem[i]) for i in jin]
    assert all(tt.graph.ntype[i] == RESIDUAL for i in tin)
    # the pools follow the parameters, as the reference's placement of
    # pool leaves assumes
    n_params = len(jax.tree_util.tree_leaves(traced["tp"]))
    pools = tree_flatten(traced["teng"].pools)[0]
    assert [float(tt.graph.mem[i]) for i in tin[n_params:n_params + 2]] \
        == [float(p.numel() * p.element_size()) for p in pools]


def _matmul_flops(g, names) -> float:
    return float(sum(g.op_flops[i] for i in range(g.n)
                     if g.names[i] in names))


def test_matmul_flops_match_reference(traced):
    jg, tg = traced["jt"].graph, traced["tt"].graph
    ours = _matmul_flops(tg, DOT_OPS)
    assert ours == _matmul_flops(jg, ("dot_general",)) > 0
    if traced["layers"] is None:
        assert ours == 1_638_400


def test_logits_bytes_match_reference(traced):
    jt, tt = traced["jt"], traced["tt"]
    jl = jt.program.out_slots[0][0]
    tl = tt.program.out_slots[0][0]
    cfg = traced["tc"]
    want = GEOMETRY["max_batch"] * cfg.padded_vocab * 4      # float32
    assert float(tt.graph.mem[tl]) == float(jt.graph.mem[jl]) == want


def test_graph_is_acyclic_and_deterministic(traced):
    tt, teng = traced["tt"], traced["teng"]
    src, dst = [], []
    for u, edges in enumerate(tt.graph.out_edges):
        for v, _ in edges:
            src.append(u)
            dst.append(v)
    # node ids are a topological order
    assert np.all(np.asarray(src) < np.asarray(dst))
    args = teng._decode_example_args()
    again = tapi.trace(teng._decode_impl, *args)
    # a trace on real tensors (the step runs once) gives the same graph
    gm, out = ttracing._functional_graph(teng._decode_impl, args,
                                         tracing_mode="real")
    real = ttracing._cost_graph(gm, out, args, dev=H100,
                                params_residual=True, record=False)
    assert again.fingerprint == real.fingerprint() == tt.fingerprint


def _weight_slices(tr, n_params: int) -> list:
    """(parameter leaf, slice bytes, bytes on the edge into the slice)
    for every per-layer slice of a stacked parameter: the reference's
    ``scan_slice`` nodes, the port's ``select`` views."""
    g, inputs = tr.graph, tr.program.input_nodes
    out = []
    for leaf, src in enumerate(inputs[:n_params]):
        for v, comm in g.out_edges[src]:
            if g.names[v].startswith(("scan_slice", "select")):
                nbytes = (comm - H100.link_latency) * H100.link_bw
                out.append((leaf, float(g.mem[v]), round(nbytes)))
    return sorted(out)


def test_weight_slices_match_reference(traced):
    """Each layer's slice of a stacked weight owns the slice's bytes, and
    the edge into it carries the slice, not the stack, as the reference's
    ``scan_slice`` does."""
    n_params = len(jax.tree_util.tree_leaves(traced["tp"]))
    ours = _weight_slices(traced["tt"], n_params)
    ref = _weight_slices(traced["jt"], n_params)
    assert ours == ref
    assert len(ours) == 9 * traced["tc"].num_layers
    assert all(mem == nbytes > 0 for _, mem, nbytes in ours)


def test_single_pe_peak_covers_reference(traced):
    """On one PE the port's graph needs at least the memory the
    reference's graph of the same step needs: it computes the same
    step."""
    ours = tapi.partition(traced["tt"], devices=1).peak_mem
    ref = repro.partition(traced["jt"], devices=1).peak_mem
    assert ours.shape == ref.shape == (1,)
    assert ours[0] >= ref[0] > 0


def _rebuilt(g) -> jgraph.CostGraph:
    """The port's graph, node by node, as the reference's CostGraph."""
    out = jgraph.CostGraph()
    for i in range(g.n):
        out.add_node(comp=float(g.comp[i]), mem=float(g.mem[i]),
                     ntype=int(g.ntype[i]), name=g.names[i])
    for u, edges in enumerate(g.out_edges):
        for v, c in edges:
            out.add_edge(u, v, comm=float(c))
    return out.finalize()


@pytest.mark.parametrize("k", [2, 4])
def test_partition_for_serving_matches_reference_partitioner(traced, k):
    plan = ts.partition_for_serving(traced["tc"], traced["tp"], devices=k,
                                    device="cpu", **GEOMETRY)
    assert plan.fingerprint == traced["tt"].fingerprint
    assert plan.meta["serving"] == GEOMETRY
    g = _rebuilt(plan.traced.graph)
    assert g.fingerprint() == plan.fingerprint
    ref = jpart.pardnn_partition(g, k)
    assert np.array_equal(ref.assignment, plan.assignment)
    assert ref.makespan == plan.makespan
    assert np.array_equal(ref.peak_mem, plan.peak_mem)
    assert plan.assignment.min() >= 0 and plan.assignment.max() < k


@pytest.mark.parametrize("k", [2, 4])
def test_peaks_hold_every_matmul_operand(traced, k):
    """A PE's peak covers, for each product it runs, the operands it
    reads and the output it writes, wherever they were made. The
    products run on PEs 1..k-1 and everything else on PE 0, so that
    every operand, a weight slice read through views included, is a copy
    from another PE."""
    g = traced["tt"].graph
    products = np.array([v for v in range(g.n) if g.names[v] in DOT_OPS])
    a = np.zeros(g.n, dtype=np.int64)
    a[products] = 1 + np.arange(len(products)) % (k - 1)
    prof = compute_profile(g, a, emulate(g, a, k), k)
    # the bytes of each operand, read off the edge that carries it
    read = np.zeros(g.n)
    for edges in g.out_edges:
        for v, comm in edges:
            read[v] += (comm - H100.link_latency) * H100.link_bw
    for v in products:
        need = g.mem[v] + read[v]
        assert prof.peak[a[v]] >= need * (1 - 1e-9), (v, a[v])


def _replay(teng, prog, vocab: int):
    """The recorded program of the decode step on random pools, a block
    table, tokens and lengths, and the eager step on the same: (program
    leaves, eager leaves), the logits first, then the pools."""
    gen = torch.Generator().manual_seed(1)
    teng.pools = tree_map(
        lambda t: torch.randn(t.shape, generator=gen).to(t.dtype),
        teng.pools)
    B, W, bs = teng.max_batch, teng.max_blocks_per_req, teng.block_size
    per_row = (GEOMETRY["num_blocks"] - 1) // B      # distinct blocks
    bt = torch.zeros((B, W), dtype=torch.int32)
    bt[:, :per_row] = (torch.randperm(B * per_row, generator=gen)
                       + 1).reshape(B, per_row)
    lens = torch.randint(0, per_row * bs, (B,), dtype=torch.int32,
                         generator=gen)
    bt[-1], lens[-1] = 0, 0                          # a padding row
    toks = torch.randint(1, vocab, (B, 1), dtype=torch.int32, generator=gen)
    leaves, _ = tree_flatten((teng.params, tree_map(torch.clone, teng.pools),
                              bt, toks, lens))
    vals = dict(prog.const_nodes)
    vals.update(zip(prog.input_nodes, leaves))

    def read(nid, idx):
        v = vals[nid]
        return v[idx] if isinstance(v, (tuple, list)) else v

    for nid in sorted(prog.program):
        op, kwargs, inputs = prog.program[nid]
        flat = [x[1] if x[0] == "lit" else read(x[1], x[2]) for x in inputs]
        vals[nid] = op(*pytree.tree_unflatten(flat, prog.arg_specs[nid]),
                       **kwargs)
    logits, pools = tree_unflatten(
        prog.out_tree, [read(*s) for s in prog.out_slots])
    want = teng._decode(bt, toks, lens)              # eager, in place
    return ([logits] + tree_flatten(pools)[0],
            [want] + tree_flatten(teng.pools)[0])


def test_recorded_program_replays_the_eager_step(traced):
    got, want = _replay(traced["teng"], traced["tt"].program,
                        traced["tc"].vocab_size)
    assert len(got) == len(want) == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _stacked_leaf_bytes(teng) -> list:
    """The bytes of each stacked pool leaf (those of the periods)."""
    return sorted(float(t.numel() * t.element_size())
                  for t in tree_flatten(teng.pools["periods"])[0])


def test_no_select_scatter_of_a_whole_stacked_leaf(cached):
    """Each layer's cache write into its period's view of a stacked cache
    is a per-index value, as the reference's scan builds its output, not
    a ``select_scatter`` copy of the whole stack; one stack a leaf holds
    the new tokens read back from the layers."""
    g = cached["tt"].graph
    least = _stacked_leaf_bytes(cached["teng"])[0]
    whole = [i for i in range(g.n) if g.names[i].startswith("select_scatter")
             and g.mem[i] >= least]
    assert whole == []
    assert sum(name == "stack" for name in g.names) == \
        len(_stacked_leaf_bytes(cached["teng"]))


#: the reference's primitives that only view their operand: its per-layer
#: slices and its reshapes, transposes and broadcasts (the port's views)
REF_VIEWS = ("scan_slice", "reshape", "transpose", "squeeze", "expand_dims",
             "broadcast_in_dim")


def _whole_size(g, nbytes: float, views) -> int:
    """Nodes made in the step (not inputs) that are not views and output
    at least ``nbytes``."""
    return sum(g.mem[i] >= nbytes and g.ntype[i] != RESIDUAL
               and not g.names[i].split(".")[0].startswith(views)
               for i in range(g.n))


def test_whole_size_nodes_no_more_than_reference(cached):
    """For each stacked leaf, the non-view nodes whose output is at least
    its bytes are no more than the reference's on the same step (granite:
    a gather and a pool write a leaf, against its jit, scan_stack and
    scatter: the new tokens are gathered from each layer's cache, not
    from a stack of them)."""
    tg, jg = cached["tt"].graph, cached["jt"].graph
    for nbytes in _stacked_leaf_bytes(cached["teng"]):
        ours = _whole_size(tg, nbytes, tuple(ttracing.VIEW_OPS))
        ref = _whole_size(jg, nbytes, REF_VIEWS)
        assert 0 < ours <= ref, nbytes
    if cached["tc"].name.startswith("granite"):
        assert _whole_size(tg, _stacked_leaf_bytes(cached["teng"])[0],
                           tuple(ttracing.VIEW_OPS)) == 4


def test_single_pe_peak_near_reference(cached):
    """On one PE the port's graph needs at least the reference's memory
    and, at 6 layers, at most 1.10x it: the whole-stack copies are gone
    (they took it to 1.275x for granite-8b and 1.226x for deepseek)."""
    ours = tapi.partition(cached["tt"], devices=1).peak_mem[0]
    ref = repro.partition(cached["jt"], devices=1).peak_mem[0]
    assert ours >= ref > 0
    if cached["layers"] == 6:
        assert ours <= 1.10 * ref, ours / ref


def test_cached_step_replays_bit_equal(cached):
    got, want = _replay(cached["teng"], cached["tt"].program,
                        cached["tc"].vocab_size)
    assert len(got) == len(want) > 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _writes(stack, new, mode: str):
    """Per-index writes into views of a stacked tensor, one index written
    twice; ``mode``: the stack returned (``"stacked"``), also read whole
    mid-chain (``"read_whole"``), or only gathered from along all of its
    leading axis (``"gathered"``)."""
    total = None
    for i in (0, 2, 0):
        stack[i].mul_(2.0).add_(new[i])
        if mode == "read_whole" and i == 2:
            total = stack.sum()
    out = stack[1] * stack[0]
    if mode == "gathered":
        rows = torch.arange(4, device=stack.device)
        return stack[:, rows, (rows + 1) % 5], out
    return (stack, out) if total is None else (stack, out, total)


@pytest.mark.parametrize("mode", ["stacked", "read_whole", "gathered"])
def test_unstack_writes_on_a_small_chain(mode):
    """A chain of writes into a stacked input becomes per-index values
    and one stack (one stack of the gathers where the stack is only
    gathered from), bit-equal to the eager function; a chain whose stack
    is read whole mid-chain is kept, and counted."""
    from repro_torch.core.executor import execute
    gen = torch.Generator().manual_seed(3)
    stack, new = (torch.randn((3, 4, 5), generator=gen),
                  torch.randn((3, 4, 5), generator=gen))

    def fn(s, n):
        return _writes(s, n, mode)
    gm, _ = ttracing._functional_graph(fn, (stack, new))
    ops = [(str(n.target), tuple(n.meta["val"].shape)) for n in gm.graph.nodes
           if n.op == "call_function"]
    kept = mode == "read_whole"
    assert gm.meta["kept_write_chains"] == int(kept)
    assert any("select_scatter" in op for op, _ in ops) == kept
    stacks = [shape for op, shape in ops if op == "aten.stack.default"]
    assert stacks == ([] if kept else [(3, 4)] if mode == "gathered"
                      else [(3, 4, 5)])
    tr = tapi.trace(fn, stack, new, record=True)
    got = execute(tr.program, None, None, stack.clone(), new)
    want = fn(stack.clone(), new)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


_W = np.random.default_rng(1).standard_normal((8, 6)).astype(np.float32)
_JW, _TW = jnp.asarray(_W), torch.from_numpy(_W)
# (reference function, port function): each prices to the same FLOPs
PRICED = {
    "exp": (jnp.exp, torch.exp),
    "log": (lambda a: jnp.log(jnp.abs(a)),
            lambda a: torch.log(torch.abs(a))),
    "tanh": (jnp.tanh, torch.tanh),
    "sigmoid": (lax.logistic, torch.sigmoid),
    "rsqrt": (lax.rsqrt, torch.rsqrt),
    "erf": (lax.erf, torch.erf),
    "sum": (lambda a: a.sum(-1), lambda a: a.sum(-1)),
    "max": (lambda a: a.max(-1), lambda a: a.amax(-1)),
    "mean": (lambda a: a.mean(-1), lambda a: a.mean(-1)),
    "integer_pow": (lambda a: a ** 2, lambda a: a ** 2),
    "pow": (lambda a: jnp.abs(a) ** 1.5, lambda a: torch.abs(a) ** 1.5),
    "silu": (lambda a: a * lax.logistic(a), F.silu),
    "matmul": (lambda a: a @ _JW, lambda a: a @ _TW),
    "cumsum": (lambda a: jnp.cumsum(a, -1), lambda a: a.cumsum(-1)),
    "topk": (lambda a: lax.top_k(a, 2)[0], lambda a: a.topk(2).values),
}


@pytest.mark.parametrize("name", sorted(PRICED))
def test_op_pricing_matches_reference(name):
    """An aten op is priced as the reference prices the primitives its
    jaxpr spells it with (a fused op as the sum of its parts)."""
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    jf, tf = PRICED[name]
    jt = repro.trace(jf, jnp.asarray(x))
    tt = tapi.trace(tf, torch.from_numpy(x))
    assert tt.graph.op_flops.sum() == jt.graph.op_flops.sum() > 0


def test_moe_topk_routing_replay():
    """The MoE layer's routing (softmax, top-k, the cumsum of slots, the
    one-hot dispatch and combine) mixes value and index outputs: the
    recorded program of its forward, and of its gradient, replays to the
    eager results (the reference's test of the same name)."""
    from repro_torch.core.executor import execute
    from repro_torch.models.moe import apply_moe, moe_init
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config("mixtral-8x7b")),
                              moe=dataclasses.replace(
                                  tcfg.get_config("mixtral-8x7b").moe,
                                  num_experts=4, d_ff=32,
                                  capacity_factor=0.75))
    p = moe_init(cfg, torch.Generator().manual_seed(1))
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))

    def fwd(p, x):
        out, aux = apply_moe(cfg, p, x)
        return (out ** 2).sum() + aux

    tr = tapi.trace(fwd, p, x, record=True)
    names = [n.split(".")[0] for n in tr.graph.names]
    assert {"sort", "cumsum", "bmm"} <= set(names)
    assert torch.equal(execute(tr.program, None, None, p, x), fwd(p, x))

    def grad(p, x):
        leaves, spec = tree_flatten((p, x))
        req = [t.detach().requires_grad_() for t in leaves]
        with torch.enable_grad():
            loss = fwd(*tree_unflatten(spec, req))
            return torch.autograd.grad(loss, req)

    tr = tapi.trace(grad, p, x, record=True, autograd=True)
    got = execute(tr.program, None, None, p, x)
    want = grad(p, x)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
