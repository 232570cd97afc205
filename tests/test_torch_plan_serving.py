"""Serving from a ParDNN plan in the port: reduced granite-8b (the
reference's reduced size, float32) on the CPU, with weights made by the JAX package and carried
across, partitioned at K=4 and folded onto the CPU (``devices=["cpu"]``,
``device_map=[0] * 4``). Plan-served greedy decode equals the JAX
reference's sequential decode and the port's local engine token for
token, under forced eviction and shuffled admission, through both
runtimes; the pools lie where the plan puts them; a saved and loaded
plan serves the same tokens; the facade's refusals; ``execute(trace=)``
lanes; the load generator against the reference's; the launcher's plan
path with its trace and metrics files. Reduced deepseek-v2-lite-16b
(MLA pools, MoE routing) served from a K=4 plan gives the reference
engine's tokens and the local engine's. The ``cuda`` tests serve on the
card and need no JAX: the reference is imported where it is used, so
that ``python -m pytest -m cuda tests/test_torch_plan_serving.py`` runs
on a machine without it."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.serving as ts  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

CPU = ["cpu"]
FOLD = [0] * 4
# the reference's block-starved geometry: 4 requests of up to 18 tokens
# against 9 allocatable blocks of 4 force preemption
STARVED = dict(block_size=4, num_blocks=10, max_batch=4, max_len=20)
N_NEW = 10


def _reference(cfg, params, prompt):
    """The reference's sequential greedy decode, with each step's top-1 /
    top-2 logit gap."""
    import jax
    import jax.numpy as jnp
    import repro.models as jm
    _prefill = jax.jit(jm.prefill, static_argnums=(0, 3))
    _decode_step = jax.jit(jm.decode_step, static_argnums=(0,))
    logits, caches = _prefill(cfg, params,
                              {"tokens": jnp.asarray(prompt)[None]}, 32)
    toks, gaps = [], []
    pos = len(prompt)
    for i in range(N_NEW):
        row = np.sort(np.asarray(logits[0, -1]))
        gaps.append(float(row[-1] - row[-2]))
        toks.append(int(jnp.argmax(logits[0, -1])))
        if i + 1 < N_NEW:
            logits, caches = _decode_step(
                cfg, params, caches, jnp.asarray([[toks[-1]]], jnp.int32),
                pos)
            pos += 1
    return toks, gaps


@pytest.fixture(scope="module")
def setup():
    import jax
    import repro.configs as jcfg
    import repro.models as jm
    jc = jcfg.reduced(jcfg.get_config("granite-8b"))
    tc = tcfg.reduced(tcfg.get_config("granite-8b"))
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32)
               for n in (6, 7, 5, 8)]
    refs = [_reference(jc, jp, p) for p in prompts]
    # no argmax near-ties: a 1e-6 difference in the sums cannot flip one
    assert min(g for _, gaps in refs for g in gaps) > 1e-3
    plan = ts.partition_for_serving(tc, tp, devices=4, device="cpu",
                                    **STARVED)
    local = _serve(ts.ServingEngine(tc, tp, device="cpu", **STARVED),
                   prompts, range(len(prompts)))
    return dict(tc=tc, tp=tp, prompts=prompts,
                refs=[t for t, _ in refs], plan=plan, local=local)


def _serve(eng, prompts, order):
    for i in order:
        eng.submit(ts.Request(rid=int(i), prompt=prompts[i],
                              max_new_tokens=N_NEW))
    done = eng.run_until_drained()
    assert eng.stats.leaked_blocks == 0
    assert eng.allocator.num_in_use == 0
    return eng, [done[i].output for i in range(len(prompts))]


@pytest.mark.parametrize("runtime", ["compiled", "interpret"])
@pytest.mark.parametrize("schedule", ["evict", "shuffled"])
def test_plan_served_tokens_equal_reference(setup, runtime, schedule):
    prompts, plan = setup["prompts"], setup["plan"]
    order = [2, 0, 3, 1] if schedule == "shuffled" else range(len(prompts))
    eng = plan.serve(setup["tc"], setup["tp"], devices=CPU,
                     device_map=FOLD, runtime=runtime, device="cpu")
    eng, outs = _serve(eng, prompts, order)
    local_eng, local = setup["local"]
    assert outs == local == setup["refs"]
    if schedule == "evict":
        assert eng.stats.preempted > 0, "schedule forced no eviction"
        assert eng.stats.preempted == local_eng.stats.preempted
    assert plan.report.serving["completed"] == len(prompts)
    assert plan.report.serving["leaked_blocks"] == 0
    if runtime == "compiled":
        st = plan.report.runtime
        assert st["num_segments"] > 1
        assert st["eager_segments"] == st["num_segments"]


def test_pools_live_on_the_pes_the_plan_assigns(setup):
    plan, tp = setup["plan"], setup["tp"]
    eng = plan.serve(setup["tc"], tp, devices=CPU, device_map=FOLD,
                     device="cpu")
    prog = plan.traced.program
    n_params = len(tree_flatten(tp)[0])
    leaves = tree_flatten(eng.pools)[0]
    assert len(eng.pool_pes) == len(eng.pool_devices) == len(leaves) > 0
    for i, leaf in enumerate(leaves):
        pe = int(plan.assignment[prog.input_nodes[n_params + i]])
        assert eng.pool_pes[i] == pe
        assert eng.pool_devices[i] == torch.device("cpu")
        assert leaf.device == eng.pool_devices[i]
    devs = ts.resolve_pool_devices(plan, n_params, eng.pools,
                                   [f"dev{pe}" for pe in range(plan.k)])
    assert devs == [f"dev{pe}" for pe in eng.pool_pes]


#: reduced deepseek-v2-lite-16b (an ``mla`` prelude, two ``mla_moe``
#: layers): 4 requests of 6-12 tokens, 10 new each, against 9
#: allocatable blocks of 4
DEEPSEEK_GEO = dict(block_size=4, num_blocks=10, max_batch=4, max_len=24)


def test_deepseek_plan_served_tokens_equal_reference_and_local():
    """A K=4 plan of reduced deepseek's paged decode step (MLA's 3-D latent
    and rope-key pools, top-k MoE routing), folded onto the CPU, serves
    the reference engine's tokens (bridged weights) and the local
    engine's, under eviction; each pool leaf lies on its PE."""
    import jax
    import repro.configs as jcfg
    import repro.models as jm
    import repro.serving as js
    arch = "deepseek-v2-lite-16b"
    jc = jcfg.reduced(jcfg.get_config(arch), layers=3)
    tc = tcfg.reduced(tcfg.get_config(arch), layers=3)
    jp = jm.init_params(jc, jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32)
               for n in (9, 6, 12, 7)]
    jeng = js.ServingEngine(jc, jp, **DEEPSEEK_GEO)
    gaps, inner = [], jeng._decode

    def decode(*args):
        out = inner(*args)
        top2 = np.sort(np.asarray(out[0][:, -1]), -1)[:, -2:]
        gaps.extend(top2[:, 1] - top2[:, 0])
        return out
    jeng._decode = decode
    for i, p in enumerate(prompts):
        jeng.submit(js.Request(rid=i, prompt=p, max_new_tokens=N_NEW))
    done = jeng.run_until_drained()
    ref = [done[i].output for i in range(len(prompts))]
    assert min(gaps) > 1e-3, "a near-tie"
    plan = ts.partition_for_serving(tc, tp, devices=4, device="cpu",
                                    **DEEPSEEK_GEO)
    assert plan.k == 4 and len(set(plan.assignment.tolist())) > 1
    local_eng, local = _serve(
        ts.ServingEngine(tc, tp, device="cpu", **DEEPSEEK_GEO), prompts,
        range(len(prompts)))
    eng = plan.serve(tc, tp, devices=CPU, device_map=FOLD, device="cpu")
    eng, outs = _serve(eng, prompts, range(len(prompts)))
    assert outs == local == ref
    assert eng.stats.preempted == local_eng.stats.preempted > 0
    prog = plan.traced.program
    n_params = len(tree_flatten(tp)[0])
    leaves = tree_flatten(eng.pools)[0]
    assert len(leaves) == 4          # c_kv and k_rope, prelude and periods
    assert eng.pool_pes == [int(plan.assignment[prog.input_nodes[n_params + i]])
                            for i in range(len(leaves))]
    assert all(leaf.device == torch.device("cpu") for leaf in leaves)


@pytest.mark.cuda
def test_write_prompt_commits_to_the_pool_device():
    """A pool placed on another device than the prefill caches (pools on
    the CPU, caches on the card) takes the chunks moved to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a second device")
    from repro_torch.models import init_cache
    tc = tcfg.reduced(tcfg.get_config("granite-8b"))
    g = torch.Generator("cuda").manual_seed(0)
    caches = init_cache(tc, 2, 16, "cuda")
    leaves, structure = tree_flatten(caches)
    caches = tree_unflatten(structure, [
        torch.randn(t.shape, generator=g, device="cuda") for t in leaves])
    on_card = ts.init_pools(tc, 6, 4, "cuda")
    on_cpu = ts.init_pools(tc, 6, 4, "cpu")
    for pools in (on_card, on_cpu):
        ts.write_prompt(pools, [1, 2, 3], caches, 1, 10, 4)
    for a, b in zip(tree_flatten(on_card)[0], tree_flatten(on_cpu)[0]):
        assert b.device.type == "cpu" and torch.equal(a.cpu(), b)


def test_saved_and_loaded_plan_serves_the_same_tokens(setup, tmp_path):
    path = setup["plan"].save(str(tmp_path / "serve.plan.json"))
    loaded = api.PartitionPlan.load(path)
    assert loaded.traced is None and loaded.meta["serving"] == \
        ts.serving_geometry(**STARVED)
    eng = loaded.serve(setup["tc"], setup["tp"], devices=CPU,
                       device_map=FOLD, device="cpu")
    assert loaded.traced is not None          # retraced and bound
    _, outs = _serve(eng, setup["prompts"], range(4))
    assert outs == setup["refs"]


def test_shape_changing_override_fails_the_fingerprint(setup, tmp_path):
    path = setup["plan"].save(str(tmp_path / "serve.plan.json"))
    loaded = api.PartitionPlan.load(path)
    with pytest.raises(api.PlanValidationError) as e:
        loaded.serve(setup["tc"], setup["tp"], devices=CPU,
                     device_map=FOLD, device="cpu", max_batch=2)
    assert e.value.code == terr.RP102_FINGERPRINT_MISMATCH


def test_plan_without_serving_geometry_refuses(setup):
    plan = setup["plan"]
    bare = api.PartitionPlan(
        assignment=plan.assignment, k=plan.k, fingerprint=plan.fingerprint,
        report=plan.report, meta={"arch": "x"}, traced=plan.traced)
    with pytest.raises(ValueError, match="serving geometry"):
        bare.serve(setup["tc"], setup["tp"], devices=CPU, device_map=FOLD,
                   device="cpu")


def test_execute_trace_writes_measured_and_predicted_lanes(setup, tmp_path):
    import repro.obs as jobs
    plan, tp = setup["plan"], setup["tp"]
    eng = ts.ServingEngine(setup["tc"], tp, device="cpu", **STARVED)
    args = eng._decode_example_args()
    path = str(tmp_path / "plan.trace.json")
    out = plan.execute(*args, devices=CPU, device_map=FOLD, trace=path)
    want = plan.execute(*args, devices=CPU, device_map=FOLD)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_flatten(out)[0], tree_flatten(want)[0]))
    doc = ttrace.load_trace(path)
    assert ttrace.validate_trace(doc) == []
    assert jobs.validate_trace(doc) == []
    nseg = plan.report.runtime["num_segments"]
    names = {pid: sorted(e["name"] for e in doc["traceEvents"]
                         if e.get("ph") == "X" and e["pid"] == pid)
             for pid in (ttrace.MEASURED_PID, ttrace.PREDICTED_PID)}
    segs = sorted(f"seg{i}" for i in range(nseg))
    assert names[ttrace.MEASURED_PID] == names[ttrace.PREDICTED_PID] == segs
    rows = ttrace.predicted_vs_measured(doc)
    assert len(rows) == nseg
    assert all(r["measured_s"] >= 0 and r["predicted_s"] >= 0 for r in rows)
    with pytest.raises(ValueError, match="compiled runtime"):
        plan.execute(*args, devices=CPU, device_map=FOLD,
                     runtime="interpret", trace=path)


def test_measure_timeline_and_plain_calls(setup):
    plan, tp = setup["plan"], setup["tp"]
    eng = ts.ServingEngine(setup["tc"], tp, device="cpu", **STARVED)
    args = eng._decode_example_args()
    plan.execute(*args, devices=CPU, device_map=FOLD)
    rt = plan._compiled_runtime[1]
    _, tl = rt.measure_timeline(*args)
    n = rt.stats.num_segments
    assert set(tl) == {"mode", "dispatch_s", "ready_s", "done_s",
                       "transfer_wait_s", "makespan_s"}
    assert all(len(tl[k]) == n for k in ("dispatch_s", "ready_s",
                                         "done_s", "transfer_wait_s"))
    assert all(0 <= r <= d for r, d in zip(tl["ready_s"], tl["done_s"]))
    assert tl["done_s"] == sorted(tl["done_s"])  # eager: schedule order
    assert tl["makespan_s"] == max(tl["done_s"])
    rt(*args)                                    # a plain call times none
    assert rt.stats.timeline()["ready_s"] == []


def test_poisson_workload_equals_reference(setup):
    import repro.serving as js
    tc = setup["tc"]
    kw = dict(rate_rps=50.0, vocab=tc.vocab_size, prompt_len=(3, 9),
              max_new_tokens=(2, 6), seed=11)
    tw, jw = ts.poisson_workload(7, **kw), js.poisson_workload(7, **kw)
    assert np.array_equal(tw.arrivals_s, jw.arrivals_s)
    assert len(tw) == len(jw) == 7
    for a, b in zip(tw.requests, jw.requests):
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.rid, a.max_new_tokens) == (b.rid, b.max_new_tokens)


def test_run_workload_through_a_plan(setup):
    tc, plan = setup["tc"], setup["plan"]
    eng = plan.serve(tc, setup["tp"], devices=CPU, device_map=FOLD,
                     device="cpu")
    wl = ts.poisson_workload(5, rate_rps=1000.0, vocab=tc.vocab_size,
                             prompt_len=(3, 6), max_new_tokens=(2, 4),
                             seed=0)
    run = ts.run_workload(eng, wl, max_concurrency=2)
    assert sorted(run["completed"]) == list(range(5))
    summ = ts.summarize(eng, run["completed"], run["wall_s"])
    assert summ["requests"] == 5 and summ["leaked_blocks"] == 0
    assert summ["generated_tokens"] == sum(r.max_new_tokens
                                           for r in wl.requests)


def test_launch_serve_plan_writes_trace_and_metrics(tmp_path):
    import repro.obs as jobs
    from repro_torch.launch import serve
    tpath, mpath = str(tmp_path / "s.trace.json"), str(tmp_path / "s.json")
    eng = serve.main(["--arch", "granite-8b", "--reduced", "--device",
                      "cpu", "--requests", "4", "--max-batch", "2",
                      "--max-new", "4", "--plan-devices", "4", "--fold",
                      "--trace", tpath, "--metrics", mpath])
    assert eng.plan is not None and eng.plan.k == 4
    assert eng.stats.completed == 4 and eng.stats.leaked_blocks == 0
    doc = ttrace.load_trace(tpath)
    assert ttrace.validate_trace(doc) == jobs.validate_trace(doc) == []
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name"}
    assert lanes == {"engine"} | {f"request {i}" for i in range(4)}
    assert tmetrics.validate_file(mpath) == []
    assert jobs.read_metrics(mpath)["completed"] == 4
    assert tmetrics.main([mpath]) == 0


@pytest.mark.cuda
def test_cuda_plan_serving_equals_local_engine():
    """On the card: the reduced plan served through CUDA graphs gives
    the local engine's tokens under forced eviction, every step after the
    first a replay of the captured graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime captures CUDA graphs")
    from repro_torch.models import init_params
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         "cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 7, 5, 8)]
    plan = ts.partition_for_serving(cfg, params, devices=4, device="cuda",
                                    **STARVED)
    local_eng, local = _serve(ts.ServingEngine(cfg, params, device="cuda",
                                               **STARVED), prompts, range(4))
    eng = plan.serve(cfg, params, device_map=api.fold_device_map(4))
    eng, outs = _serve(eng, prompts, range(4))
    assert outs == local
    assert eng.stats.preempted == local_eng.stats.preempted > 0
    st = plan.report.runtime
    assert st["graph_replays"] == st["num_segments"] > 1
    assert st["eager_segments"] == 0
    assert all(d.type == "cuda" for d in eng.pool_devices)
