"""The port's paged serving against the JAX reference: allocator
invariants, paging round trips, and token-for-token equality of the two
engines under forced eviction, on bridged weights."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each keeps the parallel test workers from
# contending for the cores
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
import repro.serving as js  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.serving as ts  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.reduced(jcfg.get_config("granite-8b"))
    tc = tcfg.reduced(tcfg.get_config("granite-8b"))
    jp = jm.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


# ---------------------------------------------------------------------------
# block allocator
# ---------------------------------------------------------------------------
def test_allocator_basic_invariants():
    a = ts.BlockAllocator(8)
    assert a.capacity == 7                 # block 0 reserved (null)
    blocks = a.alloc_many(7)
    assert len(set(blocks)) == 7 and 0 not in blocks
    with pytest.raises(ts.OutOfBlocks):
        a.alloc()
    a.free_many(blocks)
    assert a.num_in_use == 0 and a.num_free == 7 and a.peak_in_use == 7
    a.check()


def test_allocator_rejects_double_and_foreign_free():
    a = ts.BlockAllocator(8)
    b = a.alloc()
    a.free(b)
    with pytest.raises(ValueError):
        a.free(b)                          # double free
    with pytest.raises(ValueError):
        a.free(5)                          # never allocated
    with pytest.raises(ValueError):
        ts.BlockAllocator(1)               # nothing left to allocate


# ---------------------------------------------------------------------------
# paging against the reference
# ---------------------------------------------------------------------------
def _pools(jc, nb, bs, seed):
    """Random pools with the reference's tree, as both JAX and port."""
    shapes = jm.init_cache(jc, nb, bs)
    rng = np.random.default_rng(seed)
    npools = jax.tree_util.tree_map(
        lambda c: rng.standard_normal(c.shape, dtype=np.float32), shapes)
    return (jax.tree_util.tree_map(jnp.asarray, npools),
            params_from_numpy(npools, "cpu"))


def _assert_same(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = jax.tree_util.tree_leaves(ttree)
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_gather_scatter_match_reference(setup):
    jc, _, _, _ = setup
    jpools, tpools = _pools(jc, nb=8, bs=4, seed=0)
    bt = np.array([[1, 2, 3], [4, 5, 6], [7, 0, 0]], np.int32)
    lengths = np.array([5, 11, 2], np.int32)
    jdense = js.gather_pages(jpools, jnp.asarray(bt))
    tdense = ts.gather_pages(tpools, torch.from_numpy(bt))
    _assert_same(jdense, tdense)
    jdense = jax.tree_util.tree_map(lambda d: d + 7.0, jdense)
    tdense = jax.tree_util.tree_map(lambda d: d + 7.0, tdense)
    jpools = js.scatter_token(jpools, jdense, jnp.asarray(bt),
                              jnp.asarray(lengths))
    before = jax.tree_util.tree_map(torch.clone, tpools)
    out = ts.scatter_token(tpools, tdense, torch.from_numpy(bt),
                           torch.from_numpy(lengths))
    # updated in place: the returned tree holds the pool tensors
    assert all(a is b for a, b in zip(jax.tree_util.tree_leaves(out),
                                      jax.tree_util.tree_leaves(tpools)))
    _assert_same(jpools, tpools)
    # exactly one token per row changed
    leaf, old = (jax.tree_util.tree_leaves(t)[0] for t in (tpools, before))
    assert int((leaf != old).any(-1).any(-1).sum()) == len(lengths)


def test_write_prompt_matches_reference(setup):
    jc, _, _, _ = setup
    jpools, tpools = _pools(jc, nb=10, bs=4, seed=1)
    rng = np.random.default_rng(2)
    dense = jax.tree_util.tree_map(
        lambda c: rng.standard_normal(c.shape, dtype=np.float32),
        jm.init_cache(jc, 2, 16))
    for row, blocks, plen in [(0, [3, 7, 1], 10), (1, [9, 2], 8)]:
        jpools = js.write_prompt(jpools, blocks,
                                 jax.tree_util.tree_map(jnp.asarray, dense),
                                 row, plen, 4)
        ts.write_prompt(tpools, blocks, params_from_numpy(dense, "cpu"),
                        row, plen, 4)
    _assert_same(jpools, tpools)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
_prefill = jax.jit(jm.prefill, static_argnums=(0, 3))
_decode_step = jax.jit(jm.decode_step, static_argnums=(0,))


def _reference_with_gaps(cfg, params, prompt, n_new, max_len=32):
    """The reference's sequential greedy decode, with the top-1 / top-2
    logit gap of every step."""
    logits, caches = _prefill(cfg, params,
                              {"tokens": jnp.asarray(prompt)[None]}, max_len)
    toks, gaps = [], []
    pos = len(prompt)
    for i in range(n_new):
        row = np.sort(np.asarray(logits[0, -1]))
        gaps.append(float(row[-1] - row[-2]))
        toks.append(int(jnp.argmax(logits[0, -1])))
        if i + 1 < n_new:
            logits, caches = _decode_step(
                cfg, params, caches, jnp.asarray([[toks[-1]]], jnp.int32),
                pos)
            pos += 1
    return toks, gaps


def test_engine_token_equal_to_reference_under_eviction(setup):
    jc, tc, jp, tp = setup
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32)
               for n in (6, 7, 5, 8)]
    refs = [_reference_with_gaps(jc, jp, p, 10) for p in prompts]
    # no argmax near-ties: a 1e-6 difference in the sums cannot flip one
    assert min(g for _, gaps in refs for g in gaps) > 1e-3
    # 9 allocatable blocks of 4 = 36 tokens vs up to 4 x 18 demanded
    geo = dict(block_size=4, num_blocks=10, max_batch=4, max_len=20)
    jeng = js.ServingEngine(jc, jp, **geo)
    teng = ts.ServingEngine(tc, tp, device="cpu", **geo)
    for eng, Req in ((jeng, js.Request), (teng, ts.Request)):
        for i, p in enumerate(prompts):
            eng.submit(Req(rid=i, prompt=p, max_new_tokens=10))
    jdone, tdone = jeng.run_until_drained(), teng.run_until_drained()
    assert teng.stats.preempted > 0, "schedule did not force eviction"
    assert teng.stats.preempted == jeng.stats.preempted
    for i, (ref, _) in enumerate(refs):
        assert tdone[i].output == jdone[i].output == ref, i
    assert teng.stats.leaked_blocks == 0
    assert teng.allocator.num_in_use == 0
    s = teng.stats.to_dict()
    assert s["completed"] == 4 and s["generated_tokens"] >= 40
    assert s["ttft_p50_s"] is not None


def _record_decode_logits(eng, port: bool) -> list:
    """Wrap an engine's decode step to keep each step's logits."""
    seen, inner = [], eng._decode

    def wrapped(*args):
        out = inner(*args)
        logits = out if port else out[0]
        seen.append(np.asarray(logits.numpy() if port else logits))
        return out
    eng._decode = wrapped
    return seen


def _engines_equal(arch: str, key: int) -> None:
    """Reduced ``arch`` through both engines with the same requests,
    admissions and evictions: every decode step's logits within 1e-4,
    the tokens equal, no block leaked. The longest sequence (12 + 10
    tokens) passes the reduced window of 16."""
    jc = jcfg.reduced(jcfg.get_config(arch), layers=2)
    tc = tcfg.reduced(tcfg.get_config(arch), layers=2)
    jp = jm.init_params(jc, jax.random.PRNGKey(key))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, jc.vocab_size, n).astype(np.int32)
               for n in (9, 6, 12, 7)]
    geo = dict(block_size=4, num_blocks=10, max_batch=4, max_len=24)
    jeng = js.ServingEngine(jc, jp, **geo)
    teng = ts.ServingEngine(tc, tp, device="cpu", **geo)
    jlog = _record_decode_logits(jeng, port=False)
    tlog = _record_decode_logits(teng, port=True)
    for eng, Req in ((jeng, js.Request), (teng, ts.Request)):
        for i, p in enumerate(prompts):
            eng.submit(Req(rid=i, prompt=p, max_new_tokens=10))
    jdone, tdone = jeng.run_until_drained(), teng.run_until_drained()
    assert teng.stats.preempted == jeng.stats.preempted > 0
    assert len(tlog) == len(jlog) > 0
    for i, (a, b) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4,
                                   err_msg=f"decode step {i}")
    top2 = np.sort(np.concatenate([x[:, -1] for x in jlog]), -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-3, "a near-tie"
    for i in range(len(prompts)):
        assert tdone[i].output == jdone[i].output, i
    assert teng.stats.leaked_blocks == 0
    assert teng.allocator.num_in_use == 0


def test_mixtral_engine_tokens_and_logits_equal_to_reference():
    """Reduced mixtral (two swa_moe layers, window 16 < the longest
    sequence): :func:`_engines_equal`."""
    _engines_equal("mixtral-8x7b", key=2)


def test_deepseek_engine_tokens_and_logits_equal_to_reference():
    """Reduced deepseek (an ``mla`` prelude and one ``mla_moe`` block):
    :func:`_engines_equal` pages the 3-D latent and rope-key leaves
    through admission, decode steps that cross block boundaries and
    preemption."""
    _engines_equal("deepseek-v2-lite-16b", key=2)


@pytest.mark.parametrize("arch, key", [("gemma3-1b", 3),
                                       ("qwen2.5-14b", 4),
                                       ("starcoder2-7b", 5)])
def test_dense_engine_tokens_and_logits_equal_to_reference(arch, key):
    """The dense configs registered beside granite: gemma3-1b (its two
    local prelude layers' list of caches and a period of five local and
    one global layer, paged; window 16 < the longest sequence),
    qwen2.5-14b (qkv bias) and starcoder2-7b (layernorm, GELU, biases):
    :func:`_engines_equal`."""
    _engines_equal(arch, key)


def test_engine_rejects_overflow_and_small_pool(setup):
    _, tc, _, tp = setup
    eng = ts.ServingEngine(tc, tp, block_size=4, num_blocks=32,
                           max_batch=2, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="overflow"):
        eng.submit(ts.Request(rid=0, prompt=np.arange(1, 13, dtype=np.int32),
                              max_new_tokens=8))
    with pytest.raises(ValueError, match="raise num_blocks"):
        ts.ServingEngine(tc, tp, block_size=4, num_blocks=4, max_batch=1,
                         max_len=64, device="cpu")


def test_engine_without_device_asks_for_cuda(setup):
    _, tc, _, tp = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        ts.ServingEngine(tc, tp)


def test_launch_serve_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite-8b", "--reduced", "--device", "cpu", "--requests", "4",
         "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[serve] 4 requests, 16 tokens" in res.stdout
