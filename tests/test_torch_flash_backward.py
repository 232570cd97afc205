"""The flash-attention backward: its plain version against the JAX
reference's gradient, the custom ops' registrations, and (on a card) the
CUDA kernel against the plain version.

The reference has no backward kernel: it differentiates its dense
attention ``repro.models.layers._plain_gqa``. The port's plain backward
``flash_attention_bwd_ref`` is held to ``jax.vjp`` of that function on
the same seeded numpy inputs within 2e-5 in float32 (the two frameworks
sum in other orders), and the forward's row log-sum-exp, which the
``sm90`` backward reads instead of recomputing it, to a logsumexp taken
with ``jax.numpy`` under the reference's mask, also within 2e-5. The
``cuda``-marked tests hold the three backward kernels (``sm90`` for bf16
at hd 64 and 128, ``mma`` there too, ``fma`` everywhere) to the plain
version run in float32 on the same inputs, under a gate scaled to each
gradient's largest magnitude: 2e-5 in float32 (sums in another order);
2^-6 in bf16, where the outputs are rounded to bf16 (2^-9 of the
scale), D = rowsum(dO o O) is taken from the bf16 forward output (up to
3.6e-3 of dq's scale in a CPU check of the formula) and the ``sm90`` and
``mma`` kernels round P and dS to bf16 for their products (2^-9 of each
term).

JAX is imported by the fixture that needs it, so the ``cuda`` tests also
run on a machine with a card and no JAX:
``python -m pytest -m cuda tests/test_torch_flash_backward.py``.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)

# (B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap)
CASES = [
    (2, 4, 2, 24, 24, 16, True, None, 0, 0.0),       # GQA, causal
    (1, 4, 4, 20, 20, 32, False, None, 0, 0.0),      # MHA, bidirectional
    (2, 4, 1, 33, 33, 16, True, 8, 0, 0.0),          # MQA, window
    (1, 4, 2, 12, 30, 32, True, None, 18, 0.0),      # q_offset (a cache)
    (1, 2, 1, 16, 16, 64, True, None, 0, 5.0),       # softcap
    (1, 2, 2, 16, 16, 16, True, 4, -6, 0.0),         # fully masked rows
    (2, 8, 2, 16, 16, 64, True, None, 0, 0.0),       # G = 4
    (1, 2, 2, 20, 20, 192, True, None, 0, 0.0),      # MLA's nope + rope
]
IDS = [f"B{c[0]}H{c[1]}KV{c[2]}q{c[3]}k{c[4]}d{c[5]}"
       f"{'c' if c[6] else 'b'}w{c[7]}o{c[8]}s{c[9]:g}" for c in CASES]
GATE = {"float32": 2e-5, "bfloat16": 2.0 ** -6}


@pytest.fixture(scope="module")
def jx():
    """The reference's plain attention and ``jax.vjp`` (JAX on the CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax = pytest.importorskip("jax")
    from repro.models.layers import _plain_gqa
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy,
                                 plain_gqa=_plain_gqa)


def _inputs(seed, B, H, KV, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sq, H, hd), dtype=np.float32))


def _kw(case):
    causal, window, q_offset, softcap = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                softcap=softcap)


def _jax_lse(jx, arrays, case):
    """Each row's logsumexp over the reference's masked scores (the score
    and mask construction of ``_plain_gqa``), (B, H, Sq), with
    ``jax.numpy``."""
    jnp = jx.jnp
    B, H, KV, Sq, Sk, hd = case[:6]
    causal, window, q_offset, softcap = case[6:]
    q, k = jnp.asarray(arrays[0]), jnp.asarray(arrays[1])
    s = jnp.einsum("bqkgd,bskd->bkgqs", q.reshape(B, Sq, KV, H // KV, hd),
                   k) / np.sqrt(hd)
    if softcap > 0:
        s = jnp.tanh(s / softcap) * softcap
    qp = (q_offset + jnp.arange(Sq))[None, None, None, :, None]
    kp = jnp.arange(Sk)[None, None, None, None, :]
    mask = jnp.ones((), dtype=bool)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    s = jnp.where(mask, s, -jnp.inf)
    return np.asarray(jx.jax.scipy.special.logsumexp(s, axis=-1)
                      ).reshape(B, H, Sq)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_lse_matches_jax_logsumexp(jx, case):
    """The forward op's second output (what the forward kernels write for
    the ``sm90`` backward): each row's logsumexp of its scaled,
    soft-capped, visible scores within 2e-5 of ``jax.numpy``'s, and +inf
    exactly where the reference masks every key of a row."""
    arrays = _inputs(17, *case[:6])
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **_kw(case))
    assert lse.dtype == torch.float32 and lse.shape == (case[0], case[1],
                                                        case[3])
    want = _jax_lse(jx, arrays, case)
    masked = np.isneginf(want)
    got = lse.numpy()
    assert np.array_equal(np.isposinf(got), masked)
    assert masked.any() == (case[8] < 0)     # only the q_offset -6 case
    np.testing.assert_allclose(got[~masked], want[~masked], atol=2e-5,
                               rtol=2e-5)
    torch.testing.assert_close(out, ops.flash_attention(q, k, v,
                                                        **_kw(case)),
                               atol=0, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_op_with_the_forward_lse_is_the_plain_backward(case):
    """The backward op fed the forward op's lse (as autograd feeds it)
    returns the plain backward's gradients, bit for bit, in float32 and
    bf16; no launch is counted on the CPU."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(a).to(dtype)
                       for a in _inputs(19, *case[:6]))
        kw = _kw(case)
        out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
        before = ops.flash_attention_bwd.launches
        got = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
        assert ops.flash_attention_bwd.launches == before
        for g, w in zip(got, flash_attention_bwd_ref(do, q, k, v, **kw)):
            assert g.dtype == dtype
            torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_reference_vjp(jx, case):
    arrays = _inputs(7, *case[:6])
    kw = _kw(case)
    q, k, v, do = (jx.jnp.asarray(a) for a in arrays)
    _, vjp = jx.jax.vjp(lambda a, b, c: jx.plain_gqa(a, b, c, **kw), q, k, v)
    want = vjp(do)
    got = flash_attention_bwd_ref(*(torch.from_numpy(a) for a in
                                    (arrays[3],) + arrays[:3]), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_is_autograd_of_plain_forward(dtype):
    """The written-out backward equals torch.func.vjp of the plain
    forward, roundings included (bit for bit in bf16)."""
    case = CASES[2]
    q, k, v, do = (torch.from_numpy(a).to(getattr(torch, dtype))
                   for a in _inputs(3, *case[:6]))
    kw = _kw(case)
    _, vjp = torch.func.vjp(lambda a, b, c: flash_attention_ref(a, b, c,
                                                                **kw),
                            q, k, v)
    for g, w in zip(flash_attention_bwd_ref(do, q, k, v, **kw), vjp(do)):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", CASES[:5], ids=IDS[:5])
def test_autograd_through_the_op_is_the_plain_backward(case):
    """On the CPU the forward op's autograd formula calls the backward
    op, which runs the plain backward; neither counts a launch."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(11, *case[:6]))
    kw = _kw(case)
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    prim = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*prim, **kw)
    grads = torch.autograd.grad(out, prim, do)
    want = flash_attention_bwd_ref(do, q, k, v, **kw)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    _, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    direct = ops.flash_attention_bwd(do, q, k, v, out.detach(), lse, **kw)
    for g, w in zip(direct, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_opcheck(which):
    """Schema, autograd registration, fake tensors and AOT dispatch of
    both custom ops (``torch.library.opcheck``)."""
    case = CASES[2]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(5, *case[:6]))
    attrs = (True, 8, 0, 0.0)
    if which == "forward":
        args = tuple(t.requires_grad_() for t in (q, k, v)) + attrs
        op = torch.ops.repro_torch.flash_attention.default
    else:
        out, lse = flash_attention_ref(q, k, v, causal=True, window=8,
                                       return_lse=True)
        args = (do, q, k, v, out, lse) + attrs
        op = torch.ops.repro_torch.flash_attention_bwd.default
    res = torch.library.opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("case", [CASES[3], CASES[4], CASES[5]],
                         ids=[IDS[3], IDS[4], IDS[5]])
def test_opcheck_with_offset_softcap_and_masked_rows(case):
    """Both schemas (the forward returning (out, lse), the backward taking
    lse after out) under ``opcheck`` at a q_offset, a soft cap and fully
    masked rows (an lse of +inf)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(23, *case[:6]))
    causal, window, q_offset, softcap = case[6:]
    attrs = (causal, window or 0, q_offset, softcap)
    fwd = torch.library.opcheck(
        torch.ops.repro_torch.flash_attention.default,
        tuple(t.clone().requires_grad_() for t in (q, k, v)) + attrs)
    out, lse = flash_attention_ref(q, k, v, return_lse=True, **_kw(case))
    bwd = torch.library.opcheck(
        torch.ops.repro_torch.flash_attention_bwd.default,
        (do, q, k, v, out, lse) + attrs)
    for res in (fwd, bwd):
        assert set(res.values()) == {"SUCCESS"}, res


def test_fake_trace_records_one_node_each():
    """``make_fx`` on fake tensors records the forward and the backward
    as one node each, with the kernels' output shapes."""
    from torch.fx.experimental.proxy_tensor import make_fx
    case = CASES[0]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, *case[:6]))

    def step(q, k, v, do):
        prim = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            out = ops.flash_attention(*prim, causal=True)
            return torch.autograd.grad(out, prim, do)
    gm = make_fx(step, tracing_mode="fake")(q, k, v, do)
    targets = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.repro_torch.flash_attention.default) == 1
    assert targets.count(
        torch.ops.repro_torch.flash_attention_bwd.default) == 1
    outs = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
    assert [tuple(o.meta["val"].shape) for o in outs] == \
        [tuple(t.shape) for t in (q, k, v)]


@pytest.mark.parametrize("bad, error", [
    (dict(dout=(1, 5, 4, 16)), ValueError),
    (dict(dtype="out"), TypeError),
    (dict(window=0), ValueError),
    (dict(lse=(2, 4, 23)), ValueError),
    (dict(lse_dtype="bfloat16"), ValueError),
    (dict(lse=None), ValueError),
])
def test_backward_wrapper_refuses(bad, error):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, *CASES[0][:6]))
    out, lse = flash_attention_ref(q, k, v, return_lse=True)
    if "dout" in bad:
        do = torch.zeros(bad["dout"])
    if "dtype" in bad:
        out = out.double()
    if "lse" in bad:
        lse = None if bad["lse"] is None else torch.zeros(bad["lse"])
    if "lse_dtype" in bad:
        lse = lse.to(getattr(torch, bad["lse_dtype"]))
    with pytest.raises(error):
        ops.flash_attention_bwd(do, q, k, v, out, lse,
                                window=bad.get("window"))



@pytest.mark.parametrize("dtype, hd, dv, variant", [
    ("bfloat16", 64, 64, "sm90"), ("bfloat16", 128, 128, "sm90"),
    ("bfloat16", 32, 32, "fma"), ("bfloat16", 192, 128, "sm90"),
    ("bfloat16", 256, 256, "sm90"), ("float32", 128, 128, "fma"),
    ("bfloat16", 192, 192, "fma"), ("float32", 256, 256, "fma"),
    ("bfloat16", 80, 80, "sm90"), ("float32", 80, 80, "fma"),
])
def test_select_bwd_variant(dtype, hd, dv, variant):
    """``sm90`` takes the forward's sm90 set, the bf16 pairs of
    SM90_SHAPES; ``mma`` runs only by name."""
    dt = getattr(torch, dtype)
    assert ops.select_bwd_variant(dt, hd, dv) == variant
    assert ops.select_variant(dt, hd, dv) == variant
    assert ops.BWD_VARIANTS == ("sm90", "mma", "fma")
    assert ops.SM90_SHAPES == ((64, 64), (80, 80), (128, 128), (192, 128),
                               (256, 256))
    assert ops.MMA_BWD_HEAD_DIMS == (64, 128)


@pytest.mark.parametrize("variant, dtype, hd, error", [
    ("mma", "float32", 64, "takes bfloat16"),
    ("mma", "bfloat16", 32, "takes bfloat16"),
    ("wgmma", "bfloat16", 64, "unknown"),
    ("fma", "bfloat16", 64, "run on cuda"),
    ("sm90", "float32", 64, "sm90 backward takes bfloat16"),
    ("sm90", "bfloat16", 256, "run on cuda"),
    ("sm90", "bfloat16", 192, "sm90 backward takes bfloat16"),
    ("sm90", "bfloat16", 32, "sm90 backward takes bfloat16"),
    ("sm90", "bfloat16", 64, "run on cuda"),
])
def test_run_bwd_variant_refuses_what_its_kernel_cannot_take(variant, dtype,
                                                             hd, error):
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt)
                   for a in _inputs(1, 1, 2, 1, 8, 8, hd))
    before = ops.flash_attention_bwd.launches
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match=error):
        ops.run_bwd_variant(variant, do, q, k, v, q.clone(), lse)
    assert ops.flash_attention_bwd.launches == before


# ------------------------------------------------------------------ card
CUDA_CASES = CASES + [
    (1, 32, 8, 256, 256, 128, True, None, 0, 0.0),   # granite-8b heads
    (2, 12, 4, 200, 200, 64, True, None, 0, 0.0),    # repro-lm-100m heads
    (1, 2, 1, 70, 70, 256, True, None, 0, 0.0),      # hd 256
    (1, 16, 16, 130, 130, 192, True, None, 0, 0.0),  # deepseek heads
    (1, 16, 16, 130, 130, 80, False, None, 0, 0.0),  # hubert heads
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_backward_kernel_matches_plain_version(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the backward kernel runs there")
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to("cuda", dt)
                   for a in _inputs(13, *case[:6]))
    kw = _kw(case)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
    again = ops.flash_attention_bwd(do, q, k, v, out, lse, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == before + 2
    want = flash_attention_bwd_ref(do.float(), q.float(), k.float(),
                                   v.float(), **kw)
    variants = {ops.select_bwd_variant(dt, case[5])}
    if dtype == "bfloat16":
        variants.add("fma")         # the first kernel, at the same shapes
        if case[5] in ops.MMA_BWD_HEAD_DIMS:
            variants.add("mma")     # the earlier tensor-core kernel
    for variant in sorted(variants):
        if variant != ops.select_bwd_variant(dt, case[5]):
            got = ops.run_bwd_variant(variant, do, q, k, v, out, lse, **kw)
            again = ops.run_bwd_variant(variant, do, q, k, v, out, lse,
                                        **kw)
        for name, g, w, a in zip(("dq", "dk", "dv"), got, want, again):
            assert g.dtype == dt and g.shape == w.shape
            assert torch.equal(g, a), f"{variant} {name}: two calls differ"
            scale = float(w.abs().max())
            err = float((g.float() - w).abs().max())
            assert err <= GATE[dtype] * max(scale, 1e-30), \
                (variant, name, err, scale)


@pytest.mark.cuda
def test_cuda_autograd_reaches_the_backward_kernel():
    """A CUDA tensor that needs a gradient gets one from the backward
    kernel: wq, wk and wv receive gradients through attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run there")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 64, 32, device="cuda", generator=g)
    w = torch.randn(32, 3 * 64, device="cuda", generator=g,
                    requires_grad=True)
    before = ops.flash_attention_bwd.launches
    q, k, v = (x @ w).reshape(1, 64, 3, 4, 16).unbind(2)
    out = ops.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True)
    (gw,) = torch.autograd.grad(out.square().sum(), (w,))
    assert ops.flash_attention_bwd.launches == before + 1
    assert float(gw.abs().amax()) > 0 and bool(torch.isfinite(gw).all())
