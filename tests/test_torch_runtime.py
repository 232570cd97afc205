"""Plan execution in the port: reduced granite-8b (2 layers, float32) on
the CPU, partitioned at K=4 and folded onto one device. The op-by-op
interpreter and the compiled runtime (sync and async) give the eager
decode step bit for bit; the step is within 2e-5 of the JAX package's
on the same weights; the facade's RP104 / RP106 refusals, the runtime
and mode switches, liveness freeing below the all-live baseline and
under the verifier's certificate, a saved, loaded and bound plan, and
the cross-pool bookkeeping that keys block reuse on the storage. The
same runtime on the card (CUDA graphs) is held by the ``cuda`` tests,
which need no JAX: the reference is imported by the fixture that uses
it, so that ``python -m pytest -m cuda tests/test_torch_runtime.py``
runs on a machine without it."""
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
    keeps one runtime per devices and static arguments (``donate``
    changes nothing, so it rebuilds nothing); a serving plan reads its
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
    plan.execute(*args, devices=CPU, device_map=FOLD, donate=False)
    assert plan._compiled_runtime[1] is cached
    plan.execute(*args, devices=CPU, device_map=FOLD, static_argnums=())
    assert plan._compiled_runtime[1] is not cached


def test_pool_reuse_is_keyed_on_the_storage():
    """A view made on PE 1 of a value in PE 0's pool, read late on PE 2:
    dropping the value frees nothing while the view lives; dropping the
    view returns the block to PE 0's pool, whose next capture must wait
    for the segments on PEs 1 and 2 that touched either slot."""
    owners = trt._PoolOwners()
    x, w = torch.zeros(64), torch.ones(8)
    owners.pin(w)                                   # a graph input
    a = x * 2
    owners.produced((2, 0), a, pe=0, sid=0)
    v = a.view(8, 8)
    owners.read((2, 0), pe=1, sid=1)
    owners.produced((3, 0), v, pe=1, sid=1)
    owners.produced((4, 0), w[:2], pe=1, sid=1)     # a view of the input
    owners.read((3, 0), pe=2, sid=2)
    owners.read((3, 0), pe=2, sid=4)
    owners.read((3, 0), pe=0, sid=3)                # ordered by PE 0's stream
    assert owners.dropped((2, 0)) is None           # the view holds the block
    assert owners.dropped((3, 0)) == (0, {1, 4})
    assert owners.dropped((4, 0)) is None           # inputs never return
    assert owners.dropped((3, 0)) is None
    b = x + 1                                       # a new storage on PE 2
    owners.produced((5, 0), b, pe=2, sid=5)
    owners.read((5, 0), pe=0, sid=6)
    assert owners.dropped((5, 0)) == (2, {6})
    owners.produced((6, 0), torch.zeros(0), pe=0, sid=7)   # no bytes
    assert owners.dropped((6, 0)) is None


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
