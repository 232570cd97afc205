"""Flash attention with v narrower than q and k (MLA: q/k 128 nope + 64
rope, v 128), forward and backward, against the JAX reference.

On the CPU the op runs its plain versions: the forward is held to the
reference's ``_plain_gqa`` (which MLA's training branch calls with v at
its own width) and the backward to ``jax.vjp`` of it, on the same seeded
numpy inputs, within 2e-5 in float32 (the two frameworks sum in other
orders) and the reference's bf16 tolerance of 5e-2. The custom ops'
registrations (fake shapes, ``opcheck``) and a ``make_fx`` trace of
MLA's training branch need no card either.

The ``cuda``-marked tests hold the sm90 kernels at the wide pairs,
(192, 128) and (256, 256), at hubert-xlarge's (80, 80) (five 16-column
boxes; causal and not) and at (128, 128) without a mask, to the plain
version on the card (forward:
the bf16 tolerance and, against the plain version run in float32, one
bf16 step; backward: 2^-6 of each gradient's largest magnitude, as
``tests/test_torch_flash_backward.py`` explains), repeated calls
bit-equal, and the fma kernels at the same shapes (v zero-padded to the
head dim inside their wrappers). JAX is imported by the fixture that
needs it, so they also run where there is a card and no JAX:
``python -m pytest -m cuda tests/test_torch_flash_vwidth.py``.
"""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)

# (B, H, KV, Sq, Sk, hd, dv, causal, window, q_offset, softcap)
CASES = [
    (1, 4, 4, 20, 20, 24, 16, True, None, 0, 0.0),     # reduced MLA
    (2, 4, 1, 33, 33, 32, 16, True, 8, 0, 0.0),        # MQA, window
    (1, 4, 2, 12, 30, 48, 32, True, None, 18, 0.0),    # q_offset (a cache)
    (1, 2, 1, 16, 16, 64, 32, True, None, 0, 5.0),     # softcap
    (1, 2, 2, 16, 16, 32, 16, True, 4, -6, 0.0),       # fully masked rows
    (1, 2, 2, 24, 24, 192, 128, False, None, 0, 0.0),  # deepseek's pair
]
IDS = [f"B{c[0]}H{c[1]}KV{c[2]}q{c[3]}k{c[4]}d{c[5]}v{c[6]}"
       f"{'c' if c[7] else 'b'}w{c[8]}o{c[9]}s{c[10]:g}" for c in CASES]
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


@pytest.fixture(scope="module")
def jx():
    """The reference's plain attention and ``jax.vjp`` (JAX on the CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax = pytest.importorskip("jax")
    from repro.models.layers import _plain_gqa
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 plain_gqa=_plain_gqa)


def _inputs(seed, B, H, KV, Sq, Sk, hd, dv):
    """q, k, v and the output's cotangent, float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, dv), dtype=np.float32),
            rng.standard_normal((B, Sq, H, dv), dtype=np.float32))


def _kw(case):
    causal, window, q_offset, softcap = case[7:11]
    return dict(causal=causal, window=window, q_offset=q_offset,
                softcap=softcap)


def _f32(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_plain_gqa(jx, case, dtype):
    """The op's output, (B, Sq, H, dv), against the reference's dense
    attention on the same inputs rounded to ``dtype``."""
    arrays = _inputs(31, *case[:7])
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in arrays[:3])
    jq, jk, jv = (jx.jnp.asarray(a).astype(getattr(jx.jnp, dtype))
                  for a in arrays[:3])
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **_kw(case))
    B, H, _, Sq = case[:4]
    assert out.shape == (B, Sq, H, case[6]) and out.dtype == dt
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    want = jx.plain_gqa(jq, jk, jv, **_kw(case))
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_reference_vjp(jx, case):
    """dq, dk and dv in their inputs' shapes (dv at v's width) against
    ``jax.vjp`` of the reference's dense attention, float32; the op fed
    the forward's lse, as autograd feeds it, returns the plain backward
    bit for bit."""
    arrays = _inputs(37, *case[:7])
    kw = _kw(case)
    jq, jk, jv, jdo = (jx.jnp.asarray(a) for a in arrays)
    _, vjp = jx.jax.vjp(lambda a, b, c: jx.plain_gqa(a, b, c, **kw),
                        jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
    assert ops.flash_attention_bwd.launches == before
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == t.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=name)
    for g, w in zip(got, flash_attention_bwd_ref(do, q, k, v, **kw)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_through_the_op_at_its_v_width(dtype):
    """The forward op's autograd formula calls the backward op with v and
    dout at v's width; its gradients are the plain backward's, bit for
    bit, and are torch.func.vjp of the plain forward."""
    case = CASES[1]
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in _inputs(41,
                                                                *case[:7]))
    kw = _kw(case)
    prim = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(ops.flash_attention(*prim, **kw), prim, do)
    want = flash_attention_bwd_ref(do, q, k, v, **kw)
    _, vjp = torch.func.vjp(lambda a, b, c: flash_attention_ref(a, b, c,
                                                                **kw),
                            q, k, v)
    for g, w, a in zip(grads, want, vjp(do)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
        torch.testing.assert_close(g, a, atol=1e-6, rtol=1e-6)


def test_fake_shapes_follow_v_width():
    """The fake implementations give (B, Sq, H, dv) and (B, H, Sq) for the
    forward, and q's, k's and v's shapes for the backward, at hd 192 and
    dv 128."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(43, 1, 2, 2, 8, 8,
                                                        192, 128))
    with FakeTensorMode() as mode:
        fq, fk, fv, fdo = (mode.from_tensor(t) for t in (q, k, v, do))
        out, lse = torch.ops.repro_torch.flash_attention(
            fq, fk, fv, True, 0, 0, 0.0)
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            fdo, fq, fk, fv, out, lse, True, 0, 0, 0.0)
    assert tuple(out.shape) == (1, 8, 2, 128)
    assert tuple(lse.shape) == (1, 2, 8)
    assert (tuple(dq.shape), tuple(dk.shape), tuple(dv.shape)) == \
        ((1, 8, 2, 192), (1, 8, 2, 192), (1, 8, 2, 128))


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_opcheck_at_hd_192_dv_128(which):
    """Schema, autograd registration, fake tensors and AOT dispatch of
    both custom ops (``torch.library.opcheck``) at deepseek's pair, a
    window and a soft cap."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(47, 1, 2, 1, 12, 12,
                                                        192, 128))
    attrs = (True, 5, 0, 10.0)
    if which == "forward":
        args = tuple(t.requires_grad_() for t in (q, k, v)) + attrs
        op = torch.ops.repro_torch.flash_attention.default
    else:
        out, lse = flash_attention_ref(q, k, v, causal=True, window=5,
                                       softcap=10.0, return_lse=True)
        args = (do, q, k, v, out, lse) + attrs
        op = torch.ops.repro_torch.flash_attention_bwd.default
    res = torch.library.opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("bad", ["k_v_heads", "v_wider_out", "dout_width"])
def test_shape_checks_follow_v_width(bad):
    """k and v must agree in (B, Sk, KV); dout and out must have the
    forward output's shape (B, Sq, H, dv)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(53, 1, 4, 2, 8, 8,
                                                        32, 16))
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        if bad == "k_v_heads":
            ops.flash_attention(q, k, v[:, :, :1])
        elif bad == "v_wider_out":
            ops.flash_attention_bwd(do, q, k, v, torch.zeros(1, 8, 4, 32),
                                    lse)
        else:
            ops.flash_attention_bwd(torch.zeros(1, 8, 4, 32), q, k, v, out,
                                    lse)


def test_mla_training_trace_reads_v_at_its_width():
    """``make_fx`` of MLA's training branch and its gradient (a reduced
    deepseek-v2-lite, q/k 16 + 8, v 16) records one flash forward and
    one flash backward node, v at 16 going in, with no pad and no slice
    of the attention's output."""
    from torch.fx.experimental.proxy_tensor import make_fx
    import repro_torch.configs as tcfg
    from repro_torch.models import layers as tL
    cfg = dataclasses.replace(tcfg.reduced(tcfg.get_config(
        "deepseek-v2-lite-16b")), dtype="float32")
    params = tL.mla_init(cfg, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 10, cfg.d_model), dtype=np.float32))

    def step(x, params):
        xg = x.detach().requires_grad_()
        with torch.enable_grad():
            out, _ = tL.apply_mla(cfg, params, xg, positions=torch.arange(10))
            return torch.autograd.grad(out.sum(), xg)
    gm = make_fx(step, tracing_mode="fake")(x, params)
    fwd = torch.ops.repro_torch.flash_attention.default
    bwd = torch.ops.repro_torch.flash_attention_bwd.default
    calls = [n for n in gm.graph.nodes if n.op == "call_function"]
    nodes = {t: [n for n in calls if n.target == t] for t in (fwd, bwd)}
    assert len(nodes[fwd]) == len(nodes[bwd]) == 1
    vd, qk = cfg.v_head_dim, cfg.qk_nope_dim + cfg.qk_rope_dim
    assert vd < qk
    (f,), (b,) = nodes[fwd], nodes[bwd]
    assert f.args[0].meta["val"].shape[-1] == qk
    assert f.args[2].meta["val"].shape[-1] == vd       # v
    assert f.meta["val"][0].shape[-1] == vd            # out
    assert b.args[3].meta["val"].shape[-1] == vd       # v
    assert not any(n.target == torch.ops.aten.constant_pad_nd.default
                   for n in calls)


def test_select_variant_takes_sm90_at_exactly_its_shapes():
    """``sm90`` for bf16 at the pairs of SM90_SHAPES and nowhere else on
    a grid of head dims and v widths, forward and backward alike."""
    dims = (16, 32, 64, 80, 96, 128, 192, 256)
    for dtype in (torch.bfloat16, torch.float32):
        for hd in dims:
            for dv in dims:
                want = "sm90" if dtype == torch.bfloat16 and \
                    (hd, dv) in ops.SM90_SHAPES else "fma"
                assert ops.select_variant(dtype, hd, dv) == want
                assert ops.select_bwd_variant(dtype, hd, dv) == want


# ------------------------------------------------------------------ card
# (B, H, KV, Sq, Sk, hd, dv, causal, window, q_offset, softcap, kv_view)
CUDA_CASES = [
    (1, 16, 16, 300, 300, 192, 128, True, None, 0, 0.0, False),  # deepseek
    (1, 4, 2, 130, 400, 192, 128, True, None, 270, 0.0, True),   # views
    (2, 8, 2, 257, 257, 192, 128, True, 100, 0, 20.0, False),    # G 4, cap
    (1, 2, 2, 128, 128, 192, 128, False, None, 0, 0.0, False),   # bidir.
    (2, 4, 1, 200, 200, 256, 256, True, 64, 0, 0.0, False),      # gemma3
    (1, 4, 1, 1000, 1000, 256, 256, True, None, 0, 0.0, False),  # ragged
    (1, 4, 1, 256, 256, 256, 256, True, None, 0, 30.0, False),   # softcap
    (1, 4, 2, 300, 700, 256, 256, True, 128, 400, 0.0, True),    # views
    (2, 16, 16, 512, 512, 80, 80, False, None, 0, 0.0, False),   # hubert
    (1, 4, 2, 300, 300, 80, 80, True, None, 0, 0.0, False),      # ragged
    (1, 4, 2, 130, 400, 80, 80, True, 64, 270, 0.0, True),       # views
    (1, 4, 4, 200, 200, 80, 80, False, None, 0, 20.0, False),    # softcap
    (1, 8, 8, 384, 384, 128, 128, False, None, 0, 0.0, False),   # bidir.
    (1, 4, 2, 257, 257, 128, 128, False, None, 0, 0.0, False),   # G 2
]
CUDA_IDS = [f"q{c[3]}k{c[4]}d{c[5]}v{c[6]}{'c' if c[7] else 'b'}w{c[8]}"
            f"o{c[9]}s{c[10]:g}{'view' if c[11] else ''}" for c in CUDA_CASES]
TIGHT = dict(atol=1e-5, rtol=2.0 ** -7)
GATE = 2.0 ** -6


def _cuda_inputs(case, seed):
    """bf16 q, k, v, dO on the card; with ``kv_view`` k and v are views
    into larger caches (k the first Sk rows, v the last)."""
    B, H, KV, Sq, Sk, hd, dv = case[:7]
    q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   for a in _inputs(seed, B, H, KV, Sq, 2 * Sk, hd, dv))
    if case[11]:
        k, v = k[:, :Sk], v[:, Sk:]
    else:
        k, v = k[:, :Sk].contiguous(), v[:, :Sk].contiguous()
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_sm90_forward_at_wide_pairs(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, _ = _cuda_inputs(case, 61)
    kw = _kw(case)
    assert ops.select_variant(q.dtype, case[5], case[6]) == "sm90"
    before = dict(ops.flash_attention.variant_launches)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.variant_launches["sm90"] == \
        before["sm90"] + 2
    assert torch.equal(out, again)
    assert out.shape == (*q.shape[:3], case[6])
    ref = flash_attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOL["bfloat16"])
    ref32, lse32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                       return_lse=True, **kw)
    np.testing.assert_allclose(_f32(out), _f32(ref32), **TIGHT)
    finite = torch.isfinite(lse32)
    assert torch.equal(torch.isfinite(lse), finite)
    np.testing.assert_allclose(_f32(lse[finite]), _f32(lse32[finite]),
                               atol=1e-4, rtol=1e-4)
    fma, _ = ops.run_variant("fma", q, k, v, **kw)
    np.testing.assert_allclose(_f32(fma), _f32(ref32), **TIGHT)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=CUDA_IDS)
def test_cuda_sm90_backward_at_wide_pairs(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, do = _cuda_inputs(case, 67)
    kw = _kw(case)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    assert ops.select_bwd_variant(q.dtype, case[5], case[6]) == "sm90"
    want = flash_attention_bwd_ref(do.float(), q.float(), k.float(),
                                   v.float(), **kw)
    for variant in ("sm90", "fma"):
        before = dict(ops.flash_attention_bwd.variant_launches)
        got = ops.run_bwd_variant(variant, do, q, k, v, out, lse, **kw)
        again = ops.run_bwd_variant(variant, do, q, k, v, out, lse, **kw)
        torch.cuda.synchronize()
        assert ops.flash_attention_bwd.variant_launches[variant] == \
            before[variant] + 2
        for name, g, w, a, t in zip(("dq", "dk", "dv"), got, want, again,
                                    (q, k, v)):
            assert g.dtype == torch.bfloat16 and g.shape == t.shape
            assert torch.equal(g, a), f"{variant} {name}: two calls differ"
            scale = float(w.abs().max())
            err = float((g.float() - w).abs().max())
            assert err <= GATE * max(scale, 1e-30), \
                (variant, name, err, scale)
