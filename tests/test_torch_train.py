"""The port's training main path against the JAX reference: the loss,
every gradient leaf, the SGD step, the traced training graph and the
conformance loop (trace → partition K=4 → verify → execute → save/load),
on the CPU at reduced size in float32 with bridged weights and batches
made from numpy seeds.

Tolerances are the reference's: 2e-4 between the port and the reference
(XLA and PyTorch sum products in other orders), 2e-5 between the plan
engines, bit equality between dispatch modes.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
from repro.conformance.matrix import \
    make_train_step as jax_train_step  # noqa: E402
from repro.models.transformer import \
    chunked_cross_entropy as jax_ce  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.conformance import (make_train_step,  # noqa: E402
                                     run_conformance, spec_for)
from repro_torch.models.moe import capacity as moe_capacity  # noqa: E402
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ["deepseek-v2-lite-16b", "gemma3-1b", "granite-8b",
         "hubert-xlarge", "internvl2-1b", "jamba-v0.1-52b", "mixtral-8x7b",
         "qwen2.5-14b", "repro-lm-100m", "rwkv6-7b", "starcoder2-7b"]
B, S = 2, 16


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    name = request.param
    # three periods after the prelude: with one, a stacked leaf has the
    # shape of one layer's tensor with a unit axis in front, and with two
    # (= B) the shape of activations such as gemma3's (2, 16) tokens
    # against its stacked (2, hd) qk-norm scales; the trace's whole-stack
    # check would take such ops for the stack's
    full = jcfg.get_config(name)
    layers = len(full.prelude) + 3 * full.period
    jc = jcfg.reduced(full, layers=layers)
    tc = tcfg.reduced(tcfg.get_config(name), layers=layers)
    assert tc.num_periods == 3 != B
    jp = jm.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    if jc.frontend is not None:
        # a stubbed frontend's patch or frame embeddings, as the
        # reference's conformance batch makes them
        x = {"embeds": rng.standard_normal((B, S, jc.d_model),
                                           dtype=np.float32) * 0.1}
    else:
        x = {"tokens": rng.integers(0, jc.vocab_size, (B, S), np.int32)}
    batch = {**x,
             "targets": rng.integers(0, jc.vocab_size, (B, S), np.int32)}
    return jc, tc, jp, tp, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _restack(params):
    """The periods of a tree from ``unstack_periods`` stacked again."""
    return dict(params, periods=tree_map(lambda *xs: torch.stack(xs),
                                         *params["periods"]))


def _assert_leaves_close(got, want, **tol):
    g = tree_flatten(got)[0]
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == b.shape, i
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   err_msg=f"leaf {i}", **tol)


@pytest.mark.parametrize("shape, chunk, ignore", [
    ((2, 16), 8192, False),      # one chunk
    ((3, 7), 4, True),           # T = 21 not divisible by the chunk
    ((2, 12), 6, True),          # four chunks, targets of -1
])
def test_chunked_cross_entropy(shape, chunk, ignore):
    jc = jcfg.reduced(jcfg.get_config("granite-8b"))
    tc = tcfg.reduced(tcfg.get_config("granite-8b"))
    rng = np.random.default_rng(sum(shape) + chunk)
    hidden = rng.standard_normal(shape + (jc.d_model,), dtype=np.float32)
    head_w = rng.standard_normal((jc.d_model, jc.padded_vocab),
                                 dtype=np.float32) * 0.1
    targets = rng.integers(0, jc.vocab_size, shape).astype(np.int32)
    if ignore:
        targets[0, :3] = -1
    want = jax_ce(jc, jnp.asarray(hidden), jnp.asarray(head_w),
                  jnp.asarray(targets), chunk=chunk)
    got = tm.chunked_cross_entropy(tc, torch.from_numpy(hidden),
                                   torch.from_numpy(head_w),
                                   torch.from_numpy(targets), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_loss_and_every_grad_leaf_match_reference(model):
    jc, tc, jp, tp, batch = model
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(jc, p, _jbatch(batch)), has_aux=True)(jp)
    loss, parts = tm.loss_fn(tc, tp, _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]), **TOL)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               **TOL)
    assert (float(parts["aux"]) > 0) == (tc.moe is not None)
    _, _, grads = make_train_step(tc, return_grads=True)(tp, _tbatch(batch))
    assert isinstance(grads["periods"], list)
    _assert_leaves_close(_restack(grads), jgrads, **TOL)


def test_train_step_matches_reference(model):
    jc, tc, jp, tp, batch = model
    jloss, jnew = jax_train_step(jc, lr=1e-3)(jp, _jbatch(batch))
    loss, new = make_train_step(tc, lr=1e-3)(tp, _tbatch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert isinstance(new["periods"], dict)
    _assert_leaves_close(new, jnew, **TOL)


def test_in_place_step_equals_the_functional_step(model):
    """``in_place=True`` writes the functional step's new parameters
    into the given tree, bit for bit, and returns that tree."""
    _, tc, _, tp, batch = model
    loss, new = make_train_step(tc, lr=1e-3)(tp, _tbatch(batch))
    mine = tree_map(torch.clone, tp)
    loss2, out = make_train_step(tc, lr=1e-3, in_place=True)(
        mine, _tbatch(batch))
    assert out is mine and torch.equal(loss, loss2)
    for a, b in zip(tree_flatten(mine)[0], tree_flatten(new)[0]):
        assert torch.equal(a, b)


def test_forward_takes_unstacked_periods(model):
    """The list of per-period views gives the stacked tree's forward
    bit for bit, and restacking gives the stacked tensors back."""
    _, tc, _, tp, batch = model
    x = tm.embed_inputs(tc, tp, _tbatch(batch))
    pos = torch.arange(S, dtype=torch.int32)
    un = tm.unstack_periods(tc, tp)
    assert len(un["periods"]) == tc.num_periods
    a, _, _ = tm.forward(tc, tp, x, positions=pos)
    b, _, _ = tm.forward(tc, un, x, positions=pos)
    assert torch.equal(a, b)
    for s, r in zip(tree_flatten(tp)[0], tree_flatten(_restack(un))[0]):
        assert torch.equal(s, r)


def _dot_flops_formula(cfg, batch: int, seq: int) -> float:
    """3 x 2·T·(matmul parameters) + per layer, attention: 4·B·H·S²·hd
    forward and 8·B·H·S²·hd backward (dense S², as the reference's graph
    of its ``_plain_gqa`` counts; an MLA layer's hd is nope + rope, the
    width its padded v reaches the kernel at); or the RWKV6 recurrence's
    chunked products, 2·B·H·n·(2·C²·hd + 2·C·hd²) forward (chunks of C =
    min(64, S) tokens, n of them) and twice that backward. An MLA layer's
    matmul parameters are its six projections (wq, w_dkv, w_kr, w_uk,
    w_uv, wo); a mamba layer's are w_in, w_x, w_dt and w_out, and its
    scan's einsum with C is 2·T·d_inner·N forward and twice that
    backward (the tracer's price of the scan ops). An MoE layer's FFN is
    its router (3 x 2·T·d·E), the
    dispatch product (forward and the activations' gradient: 2 x
    2·G·N·E·C·d), the combine product (3 x 2·G·N·E·C·d: the combine
    weights take a gradient through the router), the expert products on
    E·G·C rows (3 x m x 2·E·G·C·d·f for m matrices an expert) and the
    shared experts' dense products, for G groups of N tokens and C
    slots."""
    T = batch * seq
    d = cfg.d_model
    if cfg.rwkv is not None:
        per_layer = 6 * d * d + 2 * d * cfg.rwkv.lora_w + 2 * d * cfg.d_ff
        hd = cfg.rwkv.head_dim
        C, n = min(64, seq), -(-seq // 64)
        mixer = 3 * 2 * batch * (d // hd) * n * (2 * C * C * hd
                                                  + 2 * C * hd * hd)
        mm = cfg.num_layers * per_layer + d * cfg.padded_vocab
        return 6.0 * T * mm + cfg.num_layers * mixer
    mats = 3 if cfg.gated_mlp else 2
    H = cfg.num_heads
    mm, mixer = d * cfg.padded_vocab, 0.0
    for kind in list(cfg.prelude) + list(cfg.block_pattern) \
            * cfg.num_periods:
        if kind.startswith("mamba"):
            di, N = d * cfg.mamba.expand, cfg.mamba.d_state
            R = max(d // 16, 1)
            mm += 2 * d * di + di * (R + 2 * N) + R * di + di * d
            mixer += 6 * T * di * N
        elif kind.startswith("mla"):
            r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim,
                             cfg.qk_rope_dim, cfg.v_head_dim)
            mm += (d * H * (nd + rd) + d * (r + rd) + r * H * (nd + vd)
                   + H * vd * d)
            mixer += 12 * batch * H * seq ** 2 * (nd + rd)
        else:
            mm += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
            mixer += 12 * batch * H * seq ** 2 * cfg.head_dim
        if kind.endswith("moe"):
            m = cfg.moe
            E, N = m.num_experts, min(1024, T)
            G, C = T // N, moe_capacity(cfg, N)
            mm += mats * d * m.d_ff * m.num_shared_experts
            mixer += (6 * T * d * E + 10 * G * N * E * C * d
                      + 6 * mats * E * G * C * d * m.d_ff)
        else:
            mm += mats * d * cfg.d_ff
    return 6.0 * T * mm + mixer


def test_training_trace(model):
    """The fake-tensor trace of the step: one forward and one backward
    kernel node per layer (flash attention, the RWKV6 recurrence, or
    the selective scan of a mamba layer), no
    ``select_backward``, no node the size of a whole stacked leaf but
    each leaf's one restack, and product FLOPs equal to the count from
    the config."""
    _, tc, _, tp, batch = model
    traced = api.trace(make_train_step(tc), tp, _tbatch(batch),
                       record=True, autograd=True)
    g = traced.graph
    ops = [n.split(".")[0] for n in g.names]
    fwd = "wkv6" if tc.rwkv is not None else "flash_attention"
    n_scan = sum(k.startswith("mamba") for k in list(tc.prelude) + list(
        tc.block_pattern) * tc.num_periods)
    assert ops.count(fwd) == tc.num_layers - n_scan
    assert ops.count(fwd + "_bwd") == tc.num_layers - n_scan
    assert ops.count("selective_scan") == n_scan
    assert ops.count("selective_scan_bwd") == n_scan
    assert "select_backward" not in ops
    # the shapes of the aten graph the cost graph was built from
    from repro_torch.core.tracing import _functional_graph, op_name
    gm, _ = _functional_graph(make_train_step(tc), (tp, _tbatch(batch)),
                              autograd=True)
    stacked = [tuple(t.shape) for t in tree_flatten(tp["periods"])[0]]
    whole = [op_name(n.target) for n in gm.graph.nodes
             if n.op == "call_function"
             and isinstance(n.meta.get("val"), torch.Tensor)
             and tuple(n.meta["val"].shape) in stacked]
    assert sorted(whole) == ["stack"] * len(stacked), whole
    assert float(g.op_dot_flops.sum()) == _dot_flops_formula(tc, B, S)
    assert float(g.op_dot_flops.sum()) <= float(g.op_flops.sum())
    # the recorded program replays to the eager step
    from repro_torch.core.executor import execute
    got = execute(traced.program, None, None, tp, _tbatch(batch))
    want = make_train_step(tc)(tp, _tbatch(batch))
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_conformance_k4_on_cpu(arch, tmp_path):
    trace = str(tmp_path / "train.trace.json")
    rec = run_conformance(spec_for(arch, devices=4), device="cpu",
                          trace_path=trace)
    assert rec["violations"] == [] and rec["ok"]
    assert rec["trace_segments_matched"] > 0
    assert rec["device_map"] == [0, 0, 0, 0] and rec["folded"]
    assert rec["sync_async_max_diff"] == 0.0
    assert rec["compiled_vs_interpreter_max_diff"] <= 2e-5
    assert np.isfinite(rec["loss"]) and rec["num_segments"] >= 4
    assert rec["diagnostics"]["counts"]["error"] == 0
