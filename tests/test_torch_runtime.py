"""Plan execution in the port: reduced granite-8b (2 layers, float32) on
the CPU, partitioned at K=4 and folded onto one device. The op-by-op
interpreter and the compiled runtime (sync and async) give the eager
decode step bit for bit; the step is within 2e-5 of the JAX package's
on the same weights; the facade's RP104 / RP106 refusals, the runtime
and mode switches, liveness freeing below the all-live baseline and
under the verifier's certificate, a saved, loaded and bound plan, and
the cross-pool bookkeeping that keys block reuse on the storage.
Donation (``donate=True``, the reference's default) is held to the
reference's ``CompiledRuntime``: the same values with and without it,
the same donated positions on synthetic programs, functional writes in
place only into a base that dies, and the caller's tensors unwritten.
The same runtime on the card (CUDA graphs, one pool per card) is held
by the ``cuda`` tests, which need no JAX: the reference is imported by
the fixtures and tests that use it, so that ``python -m pytest -m cuda
tests/test_torch_runtime.py`` runs on a machine without it."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.serving as ts  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.analysis.passes import (AnalysisContext,  # noqa: E402
                                         abstract_interpret)
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core.segments import cut_segments  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

GEOMETRY = ts.serving_geometry()
FOLD = [0] * 4
CPU = ["cpu"]


@pytest.fixture(scope="module")
def setup():
    """Bridged weights, the K=4 plan, the eager engine and one set of
    decode inputs made from a numpy seed."""
    import jax
    import repro.configs as jcfg
    import repro.models as jm
    import repro.serving as js
    jc = jcfg.reduced(jcfg.get_config("granite-8b"), layers=2)
    tc = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    plan = ts.partition_for_serving(tc, tp, devices=4, device="cpu",
                                    **GEOMETRY)
    jeng = js.ServingEngine(jc, jp, jit=False, **GEOMETRY)
    teng = ts.ServingEngine(tc, tp, device="cpu", **GEOMETRY)
    rng = np.random.default_rng(3)
    npools = jax.tree_util.tree_map(
        lambda c: rng.standard_normal(c.shape, dtype=np.float32),
        jeng.pools)
    B, W, bs = teng.max_batch, teng.max_blocks_per_req, teng.block_size
    per_row = (GEOMETRY["num_blocks"] - 1) // B
    bt = np.zeros((B, W), np.int32)
    bt[:, :per_row] = (rng.permutation(B * per_row) + 1).reshape(B, per_row)
    lens = rng.integers(0, per_row * bs, B).astype(np.int32)
    bt[-1], lens[-1] = 0, 0                          # a padding row
    toks = rng.integers(1, tc.vocab_size, (B, 1)).astype(np.int32)
    args = (tp, params_from_numpy(npools, "cpu"), torch.from_numpy(bt),
            torch.from_numpy(toks), torch.from_numpy(lens))
    want = teng._decode_impl(tp, tree_map(torch.clone, args[1]), *args[2:])
    return dict(jc=jc, jp=jp, jeng=jeng, npools=npools, np_in=(bt, toks,
                lens), plan=plan, teng=teng, args=args, want=want)


def _leaves(out):
    logits, pools = out
    return [logits] + tree_flatten(pools)[0]


def _assert_equal(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) == 3
    for a, b in zip(g, w):
        assert torch.equal(a, b)


@pytest.mark.parametrize("runtime,mode", [("interpret", None),
                                          ("compiled", "sync"),
                                          ("compiled", "async")])
def test_plan_execute_equals_eager_step(setup, runtime, mode):
    plan, args = setup["plan"], setup["args"]
    pools = tree_map(torch.clone, args[1])
    for _ in range(2):                    # a cached runtime, called again
        got = plan.execute(*args, devices=CPU, device_map=FOLD,
                           runtime=runtime, mode=mode)
        _assert_equal(got, setup["want"])
    # the functional step leaves its input pools as they were
    assert all(torch.equal(a, b) for a, b in zip(
        tree_flatten(args[1])[0], tree_flatten(pools)[0]))
    if runtime == "compiled":
        st = plan.report.runtime
        assert st["mode"] == mode and st["calls"] >= 2
        assert st["num_segments"] == sum(st["segments_per_device"]) > 1
        assert st["eager_segments"] == st["num_segments"]
        assert st["graph_replays"] == 0 and st["input_copies"] == 0
        assert st["transfers"] == st["aliased_reads"] > 0
        assert st["transfer_bytes"] == st["aliased_read_bytes"] > 0


def test_step_matches_jax_reference(setup):
    """The port's plan-executed step against the reference's decode step
    on the same weights and inputs, within the reference's 2e-5."""
    import jax
    import jax.numpy as jnp
    jeng, bt, toks, lens = setup["jeng"], *setup["np_in"]
    jpools = jax.tree_util.tree_map(jnp.asarray, setup["npools"])
    jlogits, jnew = jeng._decode_impl(setup["jp"], jpools, jnp.asarray(bt),
                                      jnp.asarray(toks), jnp.asarray(lens))
    got = setup["plan"].execute(*setup["args"], devices=CPU, device_map=FOLD)
    ref = [jlogits] + jax.tree_util.tree_leaves(jnew)
    mine = _leaves(got)
    assert len(ref) == len(mine) == 3
    for a, b in zip(ref, mine):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("devices,device_map", [
    (CPU, None),                      # 4 PEs, one device, no map
    (CPU, [0, 0]),                    # a short map
    (CPU, [0, 0, 0, 1]),              # an entry out of range
])
def test_device_resolution_refusals(setup, devices, device_map):
    with pytest.raises(terr.PlanValidationError) as e:
        setup["plan"].execute(*setup["args"], devices=devices,
                              device_map=device_map)
    assert e.value.code == terr.RP104_DEVICE_MISMATCH


def test_default_devices_need_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default devices exist")
    with pytest.raises(RuntimeError, match="cuda"):
        setup["plan"].execute(*setup["args"], device_map=FOLD)


def test_unknown_runtime_and_mode_raise(setup):
    plan, args = setup["plan"], setup["args"]
    with pytest.raises(ValueError, match="unknown runtime"):
        plan.execute(*args, devices=CPU, device_map=FOLD, runtime="jit")
    with pytest.raises(ValueError, match="'async' or 'sync'"):
        plan.execute(*args, devices=CPU, device_map=FOLD, mode="eager")


def test_mode_runtime_and_window_resolve_from_env(setup, monkeypatch):
    plan, args = setup["plan"], setup["args"]
    monkeypatch.setenv("REPRO_RUNTIME_SYNC", "1")
    assert trt.resolve_runtime_mode(None) == "sync"
    plan.execute(*args, devices=CPU, device_map=FOLD)
    assert plan.report.runtime["mode"] == "sync"
    assert plan.report.runtime["transfer_window_bytes"] == 0.0
    monkeypatch.delenv("REPRO_RUNTIME_SYNC")
    assert trt.resolve_runtime_mode(None) == "async"
    monkeypatch.setenv("REPRO_TRANSFER_WINDOW_MB", "2")
    assert trt._resolve_window(None) == 2 * 2 ** 20
    rt = trt.CompiledRuntime(plan.traced.program, plan.assignment, CPU * 4)
    assert rt.transfer_window_bytes == 2 * 2 ** 20 and rt.mode == "async"
    rt(*args)
    assert rt.stats.transfer_window_bytes == 2 * 2 ** 20
    monkeypatch.setenv("REPRO_RUNTIME", "interpret")
    calls = plan.report.runtime["calls"]
    _assert_equal(plan.execute(*args, devices=CPU, device_map=FOLD),
                  setup["want"])
    assert plan.report.runtime["calls"] == calls   # no compiled call
    monkeypatch.setenv("REPRO_RUNTIME", "bogus")
    with pytest.raises(ValueError, match="unknown runtime"):
        plan.execute(*args, devices=CPU, device_map=FOLD)


def test_execute_without_program_refuses(setup):
    plan = api.partition(setup["plan"].traced.graph, devices=4)
    assert plan.traced.program is None
    with pytest.raises(terr.PlanValidationError) as e:
        plan.execute(*setup["args"], devices=CPU, device_map=FOLD)
    assert e.value.code == terr.RP106_PLAN_NOT_EXECUTABLE


def test_liveness_frees_below_all_live_and_certificate(setup):
    """Per PE, the runtime's logical peak stays under the interpreter's
    all-live total and under the verifier's certificate (which charges a
    copy for every cross-PE read; folded PEs make none)."""
    plan = setup["plan"]
    prog, g = plan.traced.program, plan.traced.graph
    rt = trt.CompiledRuntime(prog, plan.assignment, CPU * 4)
    _assert_equal(rt(*setup["args"]), setup["want"])
    st = rt.stats
    all_live = float(np.sum(g.mem))
    peaks = np.asarray(st.peak_live_bytes)
    assert peaks.shape == (4,) and (peaks > 0).sum() >= 2
    assert peaks.max() < all_live and peaks.sum() < all_live
    assert st.freed_buffers > 0
    resident = sum(st.resident_bytes)
    assert resident == sum(float(g.mem[n]) for n in prog.input_nodes)
    ctx = AnalysisContext(prog=prog, assignment=plan.assignment, k=4,
                          schedule=cut_segments(prog, plan.assignment, k=4),
                          graph=g)
    cert = abstract_interpret(ctx).cert_peaks
    assert np.all(peaks <= cert * (1 + 1e-12)), (peaks, cert)


def test_outputs_freed_without_the_garbage_collector(setup):
    """A call's outputs die with their last reference: nothing in the
    call keeps them in a reference cycle (on the card, every call's
    clones of the pools stayed allocated until a collection)."""
    import gc
    import weakref
    plan = setup["plan"]
    gc.collect()
    gc.disable()
    try:
        out = plan.execute(*setup["args"], devices=CPU, device_map=FOLD)
        refs = [weakref.ref(t) for t in _leaves(out)]
        del out
        assert not any(r() is not None for r in refs)
    finally:
        gc.enable()


def test_loaded_and_bound_plan_executes(setup, tmp_path):
    plan = setup["plan"]
    path = plan.save(str(tmp_path / "decode.plan.json"))
    assert plan.report.diagnostics["counts"]["error"] == 0
    loaded = api.PartitionPlan.load(path, traced=plan.traced)
    assert np.array_equal(loaded.assignment, plan.assignment)
    _assert_equal(loaded.execute(*setup["args"], devices=CPU,
                                 device_map=FOLD), setup["want"])
    assert loaded.report.runtime["num_segments"] > 1


def test_execute_compiled_and_the_cached_runtime(setup):
    """The one-shot ``execute_compiled`` gives the eager step; the plan
    keeps one runtime per devices, ``donate`` and static arguments (as
    the reference's key holds ``donate``); a serving plan reads its
    parameters in place."""
    plan, args = setup["plan"], setup["args"]
    out, rt = trt.execute_compiled(plan.traced.program, plan.assignment,
                                   CPU * 4, *args, mode="sync")
    _assert_equal(out, setup["want"])
    assert rt.stats.calls == 1 and rt.stats.mode == "sync"
    assert plan.meta["static_argnums"] == [0]
    plan.execute(*args, devices=CPU, device_map=FOLD)
    cached = plan._compiled_runtime[1]
    assert cached.static_argnums == (0,)
    assert cached.donate and cached.stats.donated_inputs > 0
    plan.execute(*args, devices=CPU, device_map=FOLD)
    assert plan._compiled_runtime[1] is cached
    _assert_equal(plan.execute(*args, devices=CPU, device_map=FOLD,
                               donate=False), setup["want"])
    undonated = plan._compiled_runtime[1]
    assert undonated is not cached and not undonated.donate
    assert undonated.stats.donated_inputs == 0
    plan.execute(*args, devices=CPU, device_map=FOLD, static_argnums=())
    assert plan._compiled_runtime[1] not in (cached, undonated)


def test_pool_reuse_is_keyed_on_the_storage():
    """A view made on device 1 of a value in device 0's pool, read late
    on device 2: dropping the value frees nothing while the view lives;
    dropping the view returns the block to device 0's pool, whose next
    capture must wait for the segments on devices 1 and 2 that touched
    either slot."""
    owners = trt._PoolOwners()
    x, w = torch.zeros(64), torch.ones(8)
    owners.pin(w)                                   # a graph input
    a = x * 2
    owners.produced((2, 0), a, pool=0, sid=0)
    v = a.view(8, 8)
    owners.read((2, 0), pool=1, sid=1)
    owners.produced((3, 0), v, pool=1, sid=1)
    owners.produced((4, 0), w[:2], pool=1, sid=1)   # a view of the input
    owners.read((3, 0), pool=2, sid=2)
    owners.read((3, 0), pool=2, sid=4)
    owners.read((3, 0), pool=0, sid=3)              # ordered on device 0
    assert owners.dropped((2, 0)) is None           # the view holds the block
    assert owners.dropped((3, 0)) == (0, {1, 4})
    assert owners.dropped((4, 0)) is None           # inputs never return
    assert owners.dropped((3, 0)) is None
    b = x + 1                                       # a new storage on device 2
    owners.produced((5, 0), b, pool=2, sid=5)
    owners.read((5, 0), pool=0, sid=6)
    assert owners.dropped((5, 0)) == (2, {6})
    owners.produced((6, 0), torch.zeros(0), pool=0, sid=7)   # no bytes
    assert owners.dropped((6, 0)) is None


# ---------------------------------------------------------------- donation
def _mlp(params, x):
    h, sums = x, []
    for w1, w2 in zip(*params):
        h = torch.tanh(h @ w1) @ w2
        sums.append(torch.sum(h))
    return torch.mean(h ** 2) + torch.sum(torch.stack(sums))


def _mlp_example(L=4, D=16, H=32):
    rng = np.random.default_rng(0)
    return ((rng.standard_normal((L, D, H), dtype=np.float32) * 0.1,
             rng.standard_normal((L, H, D), dtype=np.float32) * 0.1),
            rng.standard_normal((3, D), dtype=np.float32))


def _chain(x):
    for i in range(24):
        x = torch.tanh(x + float(i))
    return torch.sum(x)


def _reference(name: str, k: int, donate: bool, *np_args, alternate=False):
    """The JAX reference's ``CompiledRuntime`` (``donate`` as given, k PEs
    folded onto the CPU device) on its twin of ``_mlp``, ``_chain`` or
    ``_aliased``: the result as numpy, and the runtime."""
    import jax
    import jax.numpy as jnp
    from repro.core import pardnn_partition
    from repro.core.runtime import CompiledRuntime
    from repro.core.tracing import trace_cost_graph

    def mlp(params, x):
        def layer(h, p):
            h = jnp.tanh(h @ p[0]) @ p[1]
            return h, jnp.sum(h)
        h, sums = jax.lax.scan(layer, x, params)
        return jnp.mean(h ** 2) + jnp.sum(sums)

    def chain(x):
        for i in range(24):
            x = jnp.tanh(x + float(i))
        return jnp.sum(x)

    fn = {"mlp": mlp, "chain": chain, "aliased": _aliased}[name]
    args = jax.tree_util.tree_map(jnp.asarray, np_args)
    g, prog = trace_cost_graph(fn, *args, record=True)
    a = _alternate(prog, g.n) if alternate else \
        pardnn_partition(g, k).assignment
    rt = CompiledRuntime(prog, a, [jax.devices()[0]] * k, donate=donate)
    return np.asarray(rt(*args)), rt


def _aliased(x):
    a = x + 1.0
    b = a * 2.0
    c = b + a
    d = a + c
    return d


def _alternate(prog, n: int) -> np.ndarray:
    """Program nodes on PEs 0 and 1 in turn (inputs on PE 0): a boundary
    at every node."""
    a = np.zeros(n, dtype=np.int64)
    for i, nid in enumerate(sorted(prog.program)):
        a[nid] = i % 2
    return a


def _flat(tree) -> list:
    return tree_flatten(tree)[0]


def _unwritten(args, kept) -> bool:
    return all(torch.equal(a, b) for a, b in zip(_flat(args), _flat(kept)))


@pytest.mark.parametrize("donate", [True, False])
def test_compiled_without_donation_matches(donate):
    """The two-layer MLP at K=2 folded onto the CPU, with and without
    donation: the JAX reference's runtime's value within 2e-5, and bit
    for bit the interpreter's, the eager call's and the other setting's;
    the caller's tensors unwritten."""
    from repro_torch.core.executor import execute
    np_params, np_x = _mlp_example()
    ref, _ = _reference("mlp", 2, donate, np_params, np_x)
    params = tuple(torch.from_numpy(p) for p in np_params)
    x = torch.from_numpy(np_x)
    kept = tree_map(torch.clone, (params, x))
    traced = api.trace(_mlp, params, x, record=True)
    plan = api.partition(traced, devices=2)
    rt = trt.CompiledRuntime(traced.program, plan.assignment, CPU * 2,
                             donate=donate)
    other = trt.CompiledRuntime(traced.program, plan.assignment, CPU * 2,
                                donate=not donate)
    got = rt(params, x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-7)
    assert torch.equal(got, other(params, x))
    assert torch.equal(got, execute(traced.program, plan.assignment,
                                    CPU * 2, params, x))
    assert torch.equal(got, _mlp(params, x))
    assert _unwritten((params, x), kept)
    assert rt.stats.num_segments > 1
    assert (rt.stats.donated_inputs > 0) == donate
    assert (rt.stats.donated_bytes > 0) == donate


@pytest.mark.parametrize("donate", [True, False])
def test_aliased_devices_do_not_donate_shared_buffers(donate):
    """On PEs folded onto one device a cross-PE read is the producer's own
    tensor: ``a``, read by segments on both PEs, is donated by none but
    its last consumer, so two calls give the eager value and the JAX
    reference's, and no read makes a copy."""
    x_np = np.arange(8.0, dtype=np.float32)
    ref, jrt = _reference("aliased", 2, donate, x_np, alternate=True)
    x = torch.from_numpy(x_np)
    traced = api.trace(_aliased, x, record=True)
    prog = traced.program
    rt = trt.CompiledRuntime(prog, _alternate(prog, traced.graph.n),
                             CPU * 2, donate=donate)
    for _ in range(2):            # consts and the env survive across calls
        out = rt(x)
        assert torch.equal(out, _aliased(x))
        np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(x, torch.from_numpy(x_np))
    st = rt.stats
    assert st.transfers == st.aliased_reads > 0
    assert st.num_transfer_edges == jrt.stats.num_transfer_edges > 0
    sched = rt.schedule
    for seg, dn in zip(sched.segments, rt.donated):
        assert all(sched.last_consumer_seg[seg.inputs[p][0]] == seg.sid
                   for p in dn)
    assert (st.donated_inputs > 0) == donate


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("seed", range(6))
def test_donated_positions_on_synth_programs(seed, k):
    """On random placed programs (the same draws as the reference's
    generator), the donated positions are the reference runtime's
    ``_effective_donations`` on PEs folded onto one device: a subset of
    ``dead_inputs``, never a program input, constant or output, each the
    last read of its value by any segment."""
    import jax
    from repro.analysis import synth as jsynth
    from repro.core.runtime import CompiledRuntime
    from repro_torch.analysis import synth
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    prog = synth.random_program(rng, n_ops=int(rng.integers(8, 40)),
                                n_inputs=int(rng.integers(1, 4)))
    a = synth.random_assignment(rng, prog, k)
    jprog = jsynth.random_program(jrng, n_ops=int(jrng.integers(8, 40)),
                                  n_inputs=int(jrng.integers(1, 4)))
    assert np.array_equal(a, jsynth.random_assignment(jrng, jprog, k))
    ref = CompiledRuntime(jprog, a, [jax.devices()[0]] * k)
    rt = trt.CompiledRuntime(prog, a, CPU * k)
    _, outputs = prog.liveness()
    roots = set(prog.input_nodes) | {nid for nid, _ in prog.const_nodes}
    for seg, dn, want in zip(rt.schedule.segments, rt.donated,
                             ref._donate_sets):
        assert set(dn) == set(want) and set(dn) <= set(seg.dead_inputs)
        for pos in dn:
            src = seg.inputs[pos][0]
            assert src in prog.program and src not in roots | outputs
            assert rt.schedule.last_consumer_seg[src] == seg.sid
    assert rt.stats.donated_inputs == sum(map(len, ref._donate_sets))
    off = trt.CompiledRuntime(prog, a, CPU * k, donate=False)
    assert not any(off.donated) and off.stats.donated_inputs == 0


def _write(x, idx, v):
    base = x * 2.0
    return base.index_put((idx,), v), x.index_put((idx,), v * 3.0)


@pytest.mark.parametrize("donate", [True, False])
def test_functional_write_runs_in_place_into_a_dying_base(donate):
    """``index_put`` into ``x * 2``, which dies there, with the product on
    PE 0 and the write on PE 1 (folded): donated, the write runs in
    place and its segment returns the base's storage; not donated, a new
    one. The write into the program input ``x`` never runs in place.
    Values bit-equal to the eager call either way; the caller's tensors
    unwritten."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(16, dtype=np.float32))
    idx = torch.tensor([3, 7, 11])
    v = torch.from_numpy(rng.standard_normal(3, dtype=np.float32))
    kept = tree_map(torch.clone, (x, idx, v))
    traced = api.trace(_write, x, idx, v, record=True)
    prog = traced.program
    a = np.zeros(traced.graph.n, dtype=np.int64)
    writes = [n for n in prog.program
              if str(prog.program[n][0]) == "aten.index_put.default"]
    assert len(writes) == 2
    mul = min(n for n in prog.program
              if str(prog.program[n][0]) == "aten.mul.Tensor")
    into_base = next(n for n in writes if prog.program[n][2][0][1] == mul)
    a[into_base] = 1
    rt = trt.CompiledRuntime(prog, a, CPU * 2, donate=donate)
    got = rt(x, idx, v)
    want = _write(x, idx, v)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _unwritten((x, idx, v), kept)
    assert rt.stats.inplace_writes == int(donate)
    seg = next(s for s in rt.schedule.segments if into_base in s.nodes)
    assert (seg.inputs.index((mul, 0)) in rt.donated[seg.sid]) == donate
    # the segment alone, on a base of the test's own
    base = x * 2.0
    ptr = base.data_ptr()
    invals = [{(mul, 0): base}.get(s) for s in seg.inputs]
    for i, s in enumerate(seg.inputs):
        if invals[i] is None:
            invals[i] = (x, idx, v)[prog.input_nodes.index(s[0])]
    del base
    out = rt._fns[seg.sid](invals)
    assert not invals
    assert (out[0].data_ptr() == ptr) == donate
    assert torch.equal(out[0], want[0])


@pytest.mark.parametrize("donate", [True, False])
def test_functional_write_local_base(donate):
    """The same program on one PE: the base is a local of the one segment
    that dies at the write, run in place when donation is on."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(16, dtype=np.float32))
    idx, v = torch.tensor([0, 15]), torch.ones(2)
    kept = tree_map(torch.clone, (x, idx, v))
    traced = api.trace(_write, x, idx, v, record=True)
    rt = trt.CompiledRuntime(traced.program, None, CPU, donate=donate)
    got = rt(x, idx, v)
    assert all(torch.equal(g, w) for g, w in zip(got, _write(x, idx, v)))
    assert _unwritten((x, idx, v), kept)
    assert rt.stats.num_segments == 1 and rt.stats.donated_inputs == 0
    assert rt.stats.inplace_writes == int(donate)


def test_donation_lowers_the_logical_peak():
    """The chain program with a boundary at every node, folded onto the
    CPU: with donation each segment's dead input is released before its
    outputs are charged, so the per-PE logical peaks are at most those
    without, all under the all-live total, and the values bit-equal to
    each other and within 2e-5 of the reference's runtime (with the same
    ``donate``)."""
    x_np = np.ones((64, 64), dtype=np.float32)
    x = torch.from_numpy(x_np)
    traced = api.trace(_chain, x, record=True)
    prog = traced.program
    a = _alternate(prog, traced.graph.n)
    peaks, outs = {}, {}
    for donate in (True, False):
        rt = trt.CompiledRuntime(prog, a, CPU * 2, donate=donate)
        outs[donate] = rt(x)
        peaks[donate] = np.asarray(rt.stats.peak_live_bytes)
        ref, _ = _reference("chain", 2, donate, x_np, alternate=True)
        np.testing.assert_allclose(outs[donate].numpy(), ref, rtol=2e-5)
        assert rt.stats.freed_buffers > 0
        assert (rt.stats.donated_inputs > 0) == donate
    assert torch.equal(outs[True], outs[False])
    assert np.all(peaks[True] <= peaks[False]), peaks
    assert peaks[False].sum() < 24 * 64 * 64 * 4        # all live


@pytest.fixture(scope="module")
def train_plan():
    """The reduced granite-8b SGD step (grads returned) traced with
    autograd and its K=4 plan, with a batch made from a numpy seed."""
    from repro_torch.conformance import make_train_step
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    step = make_train_step(cfg, 1e-3, return_grads=True)
    traced = api.trace(step, params, batch, record=True, autograd=True)
    plan = api.partition(traced, devices=4)
    return dict(plan=plan, args=(params, batch), want=step(params, batch))


@pytest.mark.parametrize("program", ["decode", "train"])
def test_plans_donate_bit_equal(setup, train_plan, program):
    """The reduced granite-8b decode and training plans at K=4 folded onto
    the CPU: with donation (the default) segments donate inputs and two
    functional writes a step run in place; donated and not,
    sync and async, the outputs are bit-equal to each other, to the
    interpreter and to the eager step, and the caller's tensors
    unwritten."""
    from repro_torch.core.executor import execute
    d = setup if program == "decode" else train_plan
    plan, args, want = d["plan"], d["args"], d["want"]
    prog = plan.traced.program
    kept = tree_map(torch.clone, args)
    outs = []
    for donate in (True, False):
        rt = trt.CompiledRuntime(prog, plan.assignment, CPU * 4,
                                 donate=donate)
        for mode in ("sync", "async"):
            rt.mode = mode
            outs.append(_flat(rt(*args)))
        st = rt.stats
        assert (st.donated_inputs > 0) == donate, st.donated_inputs
        assert (st.donated_bytes > 0) == donate
        # training: the writes into zeros (the embedding's gradient);
        # decode: the last layer's K and V cache writes (every earlier
        # layer's base is a view of the gathered cache later layers read)
        assert st.inplace_writes == 2 * int(donate), st.inplace_writes
    outs.append(_flat(execute(prog, plan.assignment, CPU * 4, *args)))
    outs.append(_flat(want))
    for got in outs[1:]:
        assert len(got) == len(outs[0])
        assert all(torch.equal(a, b) for a, b in zip(got, outs[0]))
    assert _unwritten(args, kept)


@pytest.mark.cuda
def test_cuda_view_read_late_on_another_pe():
    """On the card: a value in PE 0's pool is viewed on PE 1 and read on
    PE 2 after a long chain of products; PE 0's next segment allocates a
    tensor of the same size. That segment must wait for PE 2's reader
    before it reuses the block: async equals sync and the expected
    values over repeated calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime captures CUDA graphs")
    chain = 40

    def fn(x, m):
        a = x * 2                       # PE 0
        v = a.view(-1)                  # PE 1: a view of PE 0's block
        s = v[:1] * 0                   # PE 1
        y = m
        for _ in range(chain):          # PE 2: ~10 ms before reading v
            y = y @ m
        w = v + y.sum()                 # PE 2: the late reader
        c = x + s                       # PE 0: a block of a's size
        return w, c

    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(4096, 1024, generator=g, device="cuda")
    m = torch.eye(2048, device="cuda")
    prog = api.trace(fn, x, m, record=True).program
    ops = [str(prog.program[n][0]) for n in sorted(prog.program)]
    pe = {"aten.view.default": 1, "aten.slice.Tensor": 1,
          "aten.mm.default": 2, "aten.sum.default": 2}
    assignment = np.zeros(1 + max(prog.program), dtype=np.int64)
    assignment[prog.input_nodes[1]] = 2
    for nid, op in zip(sorted(prog.program), ops):
        assignment[nid] = pe.get(op, 0)
    nodes = sorted(prog.program)
    assignment[nodes[3]] = 1                        # s = v[:1] * 0
    assignment[nodes[-2]] = 2                       # w = v + y.sum()
    rt = trt.CompiledRuntime(prog, assignment, ["cuda"] * 3)
    assert [s.device for s in rt.schedule.segments] == [0, 1, 2, 0]
    want = ((2 * x).reshape(-1) + 2048, x)
    got = {}
    for mode in ("sync", "async") * 3:
        rt.mode = mode
        got[mode] = rt(x, m)
        assert torch.equal(got[mode][0], want[0])
        assert torch.equal(got[mode][1], want[1])
    # segment 3 waits on segment 1 for s, and on segment 2 before reuse
    assert rt._waits[3] == (1, 2) and rt.stats.reuse_waits == 1


@pytest.mark.cuda
def test_cuda_graphs_equal_eager_step():
    """On the card: every segment captured and replayed, async and sync
    bit-equal over repeated calls and to the eager step; the step's
    inputs copied into the runtime's own buffers at every call, so that
    a call with other pools leaves the first call's pools as they were,
    and parameters passed as other tensors refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime captures CUDA graphs")
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         "cuda")
    plan = ts.partition_for_serving(cfg, params, devices=4, device="cuda",
                                    **GEOMETRY)
    eng = ts.ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    g = torch.Generator("cuda").manual_seed(1)
    pools = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                           device="cuda"), eng.pools)
    B, W, bs = eng.max_batch, eng.max_blocks_per_req, eng.block_size
    per_row = (GEOMETRY["num_blocks"] - 1) // B      # distinct blocks
    bt = torch.zeros((B, W), dtype=torch.int32, device="cuda")
    bt[:, :per_row] = (torch.randperm(B * per_row, generator=g,
                                      device="cuda") + 1).reshape(
        B, per_row).int()
    lens = torch.randint(0, per_row * bs, (B,), generator=g,
                         device="cuda").int()
    toks = torch.randint(1, cfg.vocab_size, (B, 1), generator=g,
                         device="cuda").int()
    args = (params, pools, bt, toks, lens)
    want = eng._decode_impl(params, tree_map(torch.clone, pools), bt, toks,
                            lens)
    first = plan.execute(*args, device_map=FOLD, mode="sync")
    st = plan.report.runtime
    assert st["graph_replays"] == st["num_segments"] > 1
    assert st["eager_segments"] == 0 and st["compile_seconds"] > 0
    for mode in ("async", "sync") * 3:
        _assert_equal(plan.execute(*args, device_map=FOLD, mode=mode),
                      first)
    _assert_equal(first, want)
    moved = (params, tree_map(torch.clone, pools), bt, toks, lens)
    _assert_equal(plan.execute(*moved, device_map=FOLD), first)
    assert plan.report.runtime["input_copies"] == 5      # all but params
    kept = tree_map(torch.clone, pools)
    other = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                           device="cuda"), pools)
    want_other = eng._decode_impl(params, tree_map(torch.clone, other), bt,
                                  toks, lens)
    _assert_equal(plan.execute(params, other, bt, toks, lens,
                               device_map=FOLD), want_other)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(pools)[0],
                                                 tree_flatten(kept)[0]))
    _assert_equal(plan.execute(*args, device_map=FOLD), first)
    with pytest.raises(ValueError, match="static argument"):
        plan.execute(tree_map(torch.clone, params), *args[1:],
                     device_map=FOLD)
    interp = plan.execute(*args, device_map=FOLD, runtime="interpret")
    _assert_equal(interp, first)


@pytest.mark.cuda
def test_cuda_graphs_across_devices():
    """With two or more cards, the K=4 plan's PEs on distinct devices:
    cross-device reads are real copies (prefetched in async mode), and
    the step equals the eager step on one card, async as sync."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    n = min(4, torch.cuda.device_count())
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         "cuda")
    plan = ts.partition_for_serving(cfg, params, devices=4, device="cuda",
                                    **GEOMETRY)
    eng = ts.ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    pools = tree_map(torch.randn_like, eng.pools)
    B, W, bs = eng.max_batch, eng.max_blocks_per_req, eng.block_size
    per_row = (GEOMETRY["num_blocks"] - 1) // B
    bt = torch.zeros((B, W), dtype=torch.int32, device="cuda")
    bt[:, :per_row] = torch.arange(1, 1 + B * per_row, device="cuda"
                                   ).reshape(B, per_row).int()
    lens = (torch.arange(B, device="cuda") * 13 % (per_row * bs)).int()
    toks = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    args = (params, pools, bt, toks, lens)
    want = eng._decode_impl(params, tree_map(torch.clone, pools), bt, toks,
                            lens)
    device_map = [pe % n for pe in range(4)]
    got = {mode: plan.execute(*args, device_map=device_map, mode=mode)
           for mode in ("sync", "async", "sync", "async")}
    st = plan.report.runtime
    assert st["graph_replays"] == st["num_segments"]
    assert st["transfers"] > st["aliased_reads"]
    assert st["prefetched_transfers"] + st["deferred_transfers"] > 0
    for out in got.values():
        assert [t.device for t in _leaves(out)] == \
            [t.device for t in _leaves(got["sync"])]
        _assert_equal(tree_map(lambda t: t.to("cuda:0"), out), want)


@pytest.mark.cuda
def test_cuda_folded_plan_one_pool_and_donation():
    """On the card: the reduced granite-8b decode plan at K=4 folded onto
    one card captures into one graph pool, every segment on one capture
    stream and replayed on its PE's stream; with donation on and off, in
    sync and async dispatch, the step is bit-equal to the eager step,
    the waits of the pool's replay order are counted, and the caller's
    pools are unwritten."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime captures CUDA graphs")
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         "cuda")
    plan = ts.partition_for_serving(cfg, params, devices=4, device="cuda",
                                    **GEOMETRY)
    eng = ts.ServingEngine(cfg, params, device="cuda", **GEOMETRY)
    g = torch.Generator("cuda").manual_seed(2)
    pools = tree_map(lambda t: torch.randn(t.shape, generator=g,
                                           device="cuda"), eng.pools)
    B, W = eng.max_batch, eng.max_blocks_per_req
    per_row = (GEOMETRY["num_blocks"] - 1) // B
    bt = torch.zeros((B, W), dtype=torch.int32, device="cuda")
    bt[:, :per_row] = torch.arange(1, 1 + B * per_row, device="cuda"
                                   ).reshape(B, per_row).int()
    lens = (torch.arange(B, device="cuda") * 7 % (per_row * 16)).int()
    toks = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    args = (params, pools, bt, toks, lens)
    kept = tree_map(torch.clone, pools)
    want = eng._decode_impl(params, tree_map(torch.clone, pools), bt, toks,
                            lens)
    for donate in (True, False):
        rt = trt.CompiledRuntime(plan.traced.program, plan.assignment,
                                 ["cuda"] * 4, donate=donate,
                                 static_argnums=(0,))
        for mode in ("sync", "async") * 2:
            rt.mode = mode
            _assert_equal(rt(*args), want)
        st = rt.stats
        assert len(rt._pools) == len(rt._capture_streams) == 1
        assert len(rt._streams) == 4
        assert st.graph_replays == st.num_segments > 4
        assert st.eager_segments == 0 and st.reuse_waits > 0
        assert (st.donated_inputs > 0) == donate
        assert st.inplace_writes <= 2 * int(donate)
        del rt
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(pools)[0],
                                                 tree_flatten(kept)[0]))
