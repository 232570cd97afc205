"""Mamba's selective scan and block in the port against the JAX reference.

On the CPU the scan op runs its plain versions (``selective_scan_ref``
and the written-out ``selective_scan_bwd_ref``); these tests hold them
to the reference's ``models.ssm._ssm_scan_chunked`` and its ``jax.vjp``,
hold the tracer's price of both ops to the reference tracer's count of
the same function, and hold ``apply_mamba`` to the reference's in its
three cases (no cache, prefill with a cached state, decode). The CUDA
kernels are held to the plain versions by the ``cuda``-marked tests,
which run only where a card is present (and by ``chip_smoke.py``).

Tolerances: 1e-5 for the scan (float32 throughout; the reference sums in
an associative scan over chunks, the port step by step), 1e-4 for the
block (XLA and PyTorch sum the projections in other orders).

JAX is imported by the fixtures that need it, so the ``cuda`` tests also
run on a machine that has a card and no JAX:
``python -m pytest -m cuda tests/test_torch_ssm.py``.
"""
import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each keeps the parallel test workers from
# contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels.ssm import ops  # noqa: E402
from repro_torch.kernels.ssm.ref import (selective_scan_bwd_ref,  # noqa: E402
                                         selective_scan_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module")
def jx():
    """The reference's scan and block (JAX on the CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax = pytest.importorskip("jax")
    import repro
    import repro.configs as jcfg
    from repro.models import ssm
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, repro=repro,
                                 cfg=jcfg, ssm=ssm,
                                 scan=ssm._ssm_scan_chunked)


def _inputs(seed, B, S, di, N, h0=False):
    """u, Bm, Cm, h0 ~ N(0, 1); dt the model's softplus around its bias
    log(e - 1); A = -0.1 x [1..N] a channel, so that states carry over
    several steps."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    dt = np.log1p(np.exp(0.5 * n(B, S, di) + np.log(np.e - 1)))
    A = -0.1 * np.arange(1, N + 1, dtype=np.float32)[None].repeat(di, 0)
    return (n(B, S, di), dt.astype(np.float32), n(B, S, N), n(B, S, N), A,
            n(B, di, N) if h0 else None)


def _t(arrays, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device)
            for a in arrays]


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("S,chunk", [(8, 8), (5, 8), (24, 8), (32, 8)],
                         ids=["one-chunk", "short", "three-chunks",
                              "four-chunks"])
@pytest.mark.parametrize("h0", [False, True], ids=["zero-state", "h0"])
def test_plain_scan_matches_reference(jx, S, chunk, h0):
    """The op on CPU tensors (its plain version) against
    ``_ssm_scan_chunked``, within a chunk and across chunks, from a zero
    and from a given state: y and h_last."""
    arrs = _inputs(S + 10 * h0, 2, S, 6, 8, h0)
    before = ops.selective_scan.launches
    y, h_last = ops.selective_scan(*_t(arrs), chunk=chunk)
    assert ops.selective_scan.launches == before     # the CPU: uncounted
    jy, jh = jx.scan(*(jx.jnp.asarray(a) for a in arrs[:5]), chunk,
                     h0=None if arrs[5] is None else jx.jnp.asarray(arrs[5]))
    assert y.dtype == h_last.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(h_last), np.asarray(jh), **TOL)


def test_reference_fails_at_ragged_length_the_port_does_not(jx):
    """The reference cuts S into S // (S // chunk) equal chunks, which
    cannot reshape S = 17 at chunk 8; the port takes any S, and its
    result is the reference's at the one chunk that does hold S = 17."""
    arrs = _inputs(17, 1, 17, 4, 8)
    ja = [jx.jnp.asarray(a) for a in arrs[:5]]
    with pytest.raises(TypeError, match="reshape"):
        jx.scan(*ja, 8)
    y, h_last = ops.selective_scan(*_t(arrs), chunk=8)
    jy, jh = jx.scan(*ja, 17)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(h_last), np.asarray(jh), **TOL)


def _grad_inputs(arrs, h0: bool):
    leaves = _t(arrs[:5] + (arrs[5] if h0 else None,))
    return [t.requires_grad_() if t is not None else None for t in leaves]


@pytest.mark.parametrize("h0", [False, True], ids=["zero-state", "h0"])
def test_gradient_matches_reference(jx, h0):
    """Autograd through the op (its backward op: on the CPU the written-out
    ``selective_scan_bwd_ref``) against ``jax.vjp`` of the reference, with
    cotangents on y and on h_last, across three chunks."""
    B, S, di, N = 2, 24, 6, 8
    arrs = _inputs(3, B, S, di, N, True)
    rng = np.random.default_rng(4)
    dy = rng.standard_normal((B, S, di), dtype=np.float32)
    dh = rng.standard_normal((B, di, N), dtype=np.float32)
    req = _grad_inputs(arrs, h0)
    before = ops.selective_scan_bwd.launches
    y, h_last = ops.selective_scan(*req, chunk=8)
    got = torch.autograd.grad((y, h_last), [t for t in req if t is not None],
                              (torch.from_numpy(dy), torch.from_numpy(dh)))
    assert ops.selective_scan_bwd.launches == before

    def f(*a):
        return jx.scan(*a[:5], 8, h0=a[5] if h0 else None)
    ja = [jx.jnp.asarray(a) for a in arrs]
    _, vjp = jx.jax.vjp(f, *(ja if h0 else ja[:5]))
    want = vjp((jx.jnp.asarray(dy), jx.jnp.asarray(dh)))
    assert len(got) == len(want) == 5 + h0
    for name, a, b in zip(("du", "ddt", "dBm", "dCm", "dA", "dh0"), got,
                          want):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """``selective_scan_bwd_ref`` (written out, as the kernel walks it)
    against ``torch.autograd.grad`` of ``selective_scan_ref``, a ragged
    length, with and without cotangents on h_last."""
    arrs = _inputs(5, 2, 13, 5, 4, True)
    dy = torch.randn((2, 13, 5), generator=torch.Generator().manual_seed(6))
    dh = torch.randn((2, 5, 4), generator=torch.Generator().manual_seed(7))
    for cot in (dh, None):
        req = _grad_inputs(arrs, True)
        y, h_last = selective_scan_ref(*req)
        loss = (y * dy).sum() + (0 if cot is None else (h_last * cot).sum())
        want = torch.autograd.grad(loss, req)
        got = selective_scan_bwd_ref(*(t.detach() for t in req), dy, cot)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_opcheck(which):
    """Schema, autograd registration, fake tensors and AOT dispatch of
    both custom ops (``torch.library.opcheck``)."""
    u, dt, Bm, Cm, A, h0 = _t(_inputs(8, 2, 9, 4, 8, True))
    if which == "forward":
        args = tuple(t.requires_grad_() for t in (u, dt, Bm, Cm, A, h0)) \
            + (8,)
        op = torch.ops.repro_torch.selective_scan.default
    else:
        dy, dh = torch.ones_like(u), torch.ones_like(h0)
        args = (u, dt, Bm, Cm, A, None, dy, dh, 8)
        op = torch.ops.repro_torch.selective_scan_bwd.default
    res = torch.library.opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res


def test_wrapper_refuses_what_it_cannot_take():
    """Checks come before any launch: wrong dtypes, shapes and devices
    raise, and on the CPU the kernel's own entry refuses."""
    u, dt, Bm, Cm, A, h0 = _t(_inputs(9, 1, 4, 4, 8, True))
    with pytest.raises(TypeError, match="float32"):
        ops.selective_scan(u.bfloat16(), dt, Bm, Cm, A)
    with pytest.raises(ValueError, match="A must be"):
        ops.selective_scan(u, dt, Bm, Cm, A[:3])
    with pytest.raises(ValueError, match="h0 must be"):
        ops.selective_scan(u, dt, Bm, Cm, A, h0[:, :2])
    with pytest.raises(ValueError, match="chunk"):
        ops.selective_scan(u, dt, Bm, Cm, A, chunk=0)
    with pytest.raises(ValueError, match="dy must be"):
        ops.selective_scan_bwd(u, dt, Bm, Cm, A, h0, u[:, :2], h0)
    with pytest.raises(ValueError, match="run on cuda"):
        ops._launch(u, dt, Bm, Cm, A, h0)


@pytest.mark.parametrize("N", ops.STATES)
def test_select_variant_names_reg(N):
    """Every d_state the kernels take launches the ``reg`` pair."""
    assert ops.select_variant(N) == "reg"
    assert ops.select_variant(N) in ops.VARIANTS


@pytest.mark.parametrize("N", [4, 32])
def test_select_variant_refuses_other_states(N):
    with pytest.raises(ValueError, match="d_state"):
        ops.select_variant(N)


@pytest.mark.parametrize("B,di,N,want", [
    (8, 8192, 16, 16), (1, 8192, 16, 4), (8, 8192, 8, 8), (1, 1024, 16, 4),
    (4, 8192, 16, 16), (2, 100, 8, 4)],
    ids=["prefill", "training", "N8", "small", "B4", "tiny"])
def test_fwd_states_split(B, di, N, want):
    """The ``reg`` forward gives a thread all N states where batch x
    d_inner fills the card (FULL_STATE_THREADS), else four."""
    assert ops.fwd_states(B, di, N) == want
    assert N % ops.fwd_states(B, di, N) == 0


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_run_variant_refuses_unknown_names_and_cpu_tensors(which):
    """``run_variant`` and ``run_bwd_variant`` launch a kernel by name on
    CUDA tensors only: an unknown name raises, and so does every known
    name on CPU tensors (no plain fallback), counting nothing."""
    u, dt, Bm, Cm, A, h0 = _t(_inputs(12, 1, 5, 4, 16, True))
    fn, extra = ops.run_variant, ()
    counts = ops.selective_scan.variant_launches
    if which == "backward":
        fn, extra = ops.run_bwd_variant, (torch.ones_like(u),
                                         torch.ones_like(h0))
        counts = ops.selective_scan_bwd.variant_launches
    before = dict(counts)
    with pytest.raises(ValueError, match="unknown"):
        fn("fast", u, dt, Bm, Cm, A, h0, *extra)
    for variant in ops.VARIANTS:
        with pytest.raises(ValueError, match="run on cuda"):
            fn(variant, u, dt, Bm, Cm, A, h0, *extra)
    assert counts == before


def test_cpu_scan_runs_plain_version_and_counts_no_variant():
    """A CPU tensor through the op runs the plain versions, forward and
    backward (autograd), bit for bit, and no kernel count moves."""
    arrs = _inputs(13, 2, 11, 6, 16, True)
    req = _grad_inputs(arrs, True)
    counts = [dict(f.variant_launches) for f in (ops.selective_scan,
                                                 ops.selective_scan_bwd)]
    totals = (ops.selective_scan.launches, ops.selective_scan_bwd.launches)
    y, h_last = ops.selective_scan(*req)
    got = torch.autograd.grad(y.sum() + h_last.square().sum(), req)
    assert counts == [dict(f.variant_launches) for f in (
        ops.selective_scan, ops.selective_scan_bwd)]
    assert totals == (ops.selective_scan.launches,
                      ops.selective_scan_bwd.launches)
    plain = [t.detach() for t in req]
    wy, wh = selective_scan_ref(*plain)
    assert torch.equal(y.detach(), wy) and torch.equal(h_last.detach(), wh)
    want = selective_scan_bwd_ref(*plain, torch.ones_like(wy), 2 * wh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- the tracer's price ------------------------------------------------------
#: (B, S, d_inner, N, chunk, h0): reduced jamba's training shape (two
#: chunks of 8) and a one-row shape from a state (three chunks; at B = 1
#: the reference's gradient drops broadcasts of the unit axis)
PRICED = [(2, 16, 128, 8, 8, False), (1, 24, 128, 8, 8, True)]


@pytest.mark.parametrize("B,S,di,N,chunk,h0", PRICED)
@pytest.mark.parametrize("grad", [False, True], ids=["forward", "gradient"])
def test_scan_pricing_matches_reference(jx, B, S, di, N, chunk, h0, grad):
    """The FLOPs of a traced call of the scan op (forward, or forward and
    backward) equal the reference tracer's count of ``_ssm_scan_chunked``
    (or of its ``jax.vjp``), which unrolls the associative scan: the
    closed form in ``repro_torch.core.tracing`` is exact."""
    from repro_torch import api
    arrs = _inputs(10, B, S, di, N, True) + tuple(
        np.ones(s, np.float32) for s in ((B, S, di), (B, di, N)))
    ja = [jx.jnp.asarray(a) for a in arrs]
    tt = _t(arrs)

    def jf(u, dt, Bm, Cm, A, h):
        return jx.scan(u, dt, Bm, Cm, A, chunk, h0=h if h0 else None)

    def tf(u, dt, Bm, Cm, A, h):
        return ops.selective_scan(u, dt, Bm, Cm, A, h if h0 else None,
                                  chunk)
    if not grad:
        want = jx.repro.trace(jf, *ja[:6]).graph.op_flops.sum()
        got = api.trace(tf, *tt[:6]).graph
    else:
        def jg(*a):
            out, vjp = jx.jax.vjp(jf, *a[:6])
            return out, vjp((a[6], a[7]))
        want = jx.repro.trace(jg, *ja).graph.op_flops.sum()

        def tg(*a):
            req = [t.detach().requires_grad_() for t in a[:6]]
            with torch.enable_grad():
                out = tf(*req)
                grads = torch.autograd.grad(
                    out, req if h0 else req[:5], (a[6], a[7]))
            return [o.detach() for o in out], grads
        got = api.trace(tg, *tt, autograd=True).graph
    names = [n.split(".")[0] for n in got.names]
    assert names.count("selective_scan") == 1
    assert names.count("selective_scan_bwd") == int(grad)
    priced = sum(f for n, f in zip(names, got.op_flops)
                 if n.startswith("selective_scan"))
    assert priced == got.op_flops.sum() == want > 0


# -- the block ---------------------------------------------------------------
@pytest.fixture(scope="module")
def block(jx):
    """Reduced jamba's first mamba layer in both packages (float32, the
    reference's weights bridged)."""
    import repro_torch.configs as tcfg
    from repro_torch.bridge import params_from_numpy
    jc = jx.cfg.reduced(jx.cfg.get_config(ARCH))
    tc = tcfg.reduced(tcfg.get_config(ARCH))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jp = jx.ssm.mamba_init(jc, jx.jax.random.PRNGKey(2))
    tp = params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)


def _caches(jx, jc, tc, B):
    from repro_torch.models.ssm import mamba_cache_init
    return (jx.ssm.mamba_cache_init(jc, B, jx.jnp.float32),
            mamba_cache_init(tc, B, torch.float32, "cpu"))


@pytest.mark.parametrize("S", [12, 16], ids=["ragged", "two-chunks"])
def test_apply_mamba_without_cache_matches(jx, block, S):
    """Training's case: no cache (S = 12 is ragged at chunk 8: the
    reference takes it as one chunk of 12)."""
    from repro_torch.models.ssm import apply_mamba
    jc, tc, jp, tp = block
    x = _x(jc, 2, S, seed=S)
    jo, jcache = jx.ssm.apply_mamba(jc, jp, jx.jnp.asarray(x))
    to, tcache = apply_mamba(tc, tp, torch.from_numpy(x))
    assert jcache is None and tcache is None
    np.testing.assert_allclose(_np(to), np.asarray(jo), **BLOCK_TOL)


@pytest.mark.parametrize("S2", [8, 1], ids=["prefill-with-state", "decode"])
def test_apply_mamba_with_cache_matches(jx, block, S2):
    """A prompt of 6 tokens into a zero cache, then 8 more (the chunked
    scan from the cached state) or 1 (the reference's decode step): the
    outputs and every cache leaf, which the port writes in place."""
    from repro_torch.models.ssm import apply_mamba
    jc, tc, jp, tp = block
    jcache, tcache = _caches(jx, jc, tc, 2)
    for S, seed in ((6, 20), (S2, 21)):
        x = _x(jc, 2, S, seed)
        jo, jcache = jx.ssm.apply_mamba(jc, jp, jx.jnp.asarray(x),
                                        cache=jcache)
        to, out_cache = apply_mamba(tc, tp, torch.from_numpy(x),
                                    cache=tcache)
        assert out_cache is tcache                 # written in place
        np.testing.assert_allclose(_np(to), np.asarray(jo), **BLOCK_TOL)
        for leaf in ("conv", "h"):
            assert tcache[leaf].dtype == torch.float32
            np.testing.assert_allclose(_np(tcache[leaf]),
                                       np.asarray(jcache[leaf]),
                                       **BLOCK_TOL, err_msg=leaf)


def test_apply_mamba_bf16_matches(jx, block):
    """The block in bfloat16 (weights, x and the conv cache; the scan,
    dt, A and D in float32, as in the reference), a prompt of 8 tokens
    then one decode step. The port rounds where the reference does (the
    projections, the conv's float32 sum, each step of SiLU), so the bf16
    leaves are bit-equal but where XLA and PyTorch sum a product in
    another order and land one bf16 step apart: at most 1% of the
    elements, each within 2^-8 of the leaf's largest magnitude. The
    float32 state differs by the order of the scan's sums: 1e-5 of its
    scale."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.ssm import apply_mamba, mamba_cache_init
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in block[:2])
    bf = jx.jnp.bfloat16
    jp = jx.ssm.mamba_init(jc, jx.jax.random.PRNGKey(3))
    tp = params_from_numpy(jx.jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["w_in"].dtype == torch.bfloat16
    assert tp["A_log"].dtype == torch.float32
    jcache = jx.ssm.mamba_cache_init(jc, 2, bf)
    tcache = mamba_cache_init(tc, 2, torch.bfloat16, "cpu")
    x = _x(jc, 2, 9, seed=30)

    def close(a, b, frac, share, what):
        a = a.float().numpy()
        b = np.asarray(b.astype(jx.jnp.float32))
        assert np.abs(a - b).max() <= frac * np.abs(b).max(), what
        assert (a != b).mean() <= share, what
    for lo, hi in ((0, 8), (8, 9)):
        jo, jcache = jx.ssm.apply_mamba(
            jc, jp, jx.jnp.asarray(x[:, lo:hi]).astype(bf), cache=jcache)
        to, _ = apply_mamba(tc, tp, torch.from_numpy(x[:, lo:hi]).bfloat16(),
                            cache=tcache)
        assert to.dtype == torch.bfloat16
        assert tcache["h"].dtype == torch.float32
        close(to, jo, 2.0 ** -8, 0.01, f"out {hi}")
        close(tcache["conv"], jcache["conv"], 2.0 ** -8, 0.01, f"conv {hi}")
        close(tcache["h"], jcache["h"], 1e-5, 1.0, f"h {hi}")


# -- the CUDA kernels --------------------------------------------------------
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


#: (B, S, d_inner, N, h0): d_inner not a multiple of a block's channels,
#: S past and short of the 32-step tiles, one token from a state
CUDA_CASES = [(2, 100, 70, 16, False), (1, 64, 256, 16, True),
              (3, 33, 40, 8, True), (8, 1, 512, 16, True),
              (1, 300, 128, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,h0", CUDA_CASES)
def test_cuda_kernels_match_plain_versions(B, S, di, N, h0):
    """Both kernels against the plain versions on the same inputs, every
    output within 1e-5 of its largest magnitude (float32; the order of
    the sums and __expf differ), repeated calls bit-equal, one launch
    each counted."""
    _cuda()
    u, dt, Bm, Cm, A, h = _t(_inputs(B * S + di, B, S, di, N, h0), "cuda")
    before = (ops.selective_scan.launches, ops.selective_scan_bwd.launches)
    out = ops.selective_scan(u, dt, Bm, Cm, A, h)
    again = ops.selective_scan(u, dt, Bm, Cm, A, h)
    dy, dh = torch.randn_like(out[0]), torch.randn_like(out[1])
    grads = ops.selective_scan_bwd(u, dt, Bm, Cm, A, h, dy, dh)
    grads2 = ops.selective_scan_bwd(u, dt, Bm, Cm, A, h, dy, dh)
    torch.cuda.synchronize()
    assert (ops.selective_scan.launches,
            ops.selective_scan_bwd.launches) == (before[0] + 2,
                                                 before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    want = selective_scan_ref(u, dt, Bm, Cm, A, h)
    want_grads = selective_scan_bwd_ref(u, dt, Bm, Cm, A, h, dy, dh)
    for a, b in zip(out + grads, want + want_grads):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-5, err


#: the ``reg`` kernels' edges: the state split at small B (B=1, four
#: states a thread), one token from a state at B=1 and B=8, S around the
#: 8-step sub-tiles and 16-step tiles, d_inner not a multiple of a
#: block's channels (64 or 128 backward, 32 or 128 forward), N = 8
EDGE_CASES = [(1, 2048, 1024, 16, False), (1, 1, 1024, 16, True),
              (8, 1, 1024, 16, True), (1, 31, 200, 16, True),
              (2, 33, 200, 16, False), (1, 65, 72, 16, True),
              (2, 65, 130, 8, True), (1, 17, 8192, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,h0", CUDA_CASES + EDGE_CASES)
@pytest.mark.parametrize("variant", ops.VARIANTS)
def test_cuda_variants_match_plain_versions(variant, B, S, di, N, h0):
    """Each kernel pair by name (``run_variant``, ``run_bwd_variant``)
    against the plain versions, every output within 1e-5 of its largest
    magnitude, repeated calls bit-equal, each launch counted under its
    variant."""
    _cuda()
    u, dt, Bm, Cm, A, h = _t(_inputs(B * S + di + 1, B, S, di, N, h0),
                             "cuda")
    counts = (ops.selective_scan.variant_launches,
              ops.selective_scan_bwd.variant_launches)
    before = [dict(c) for c in counts]
    out = ops.run_variant(variant, u, dt, Bm, Cm, A, h)
    again = ops.run_variant(variant, u, dt, Bm, Cm, A, h)
    dy, dh = torch.randn_like(out[0]), torch.randn_like(out[1])
    grads = ops.run_bwd_variant(variant, u, dt, Bm, Cm, A, h, dy, dh)
    grads2 = ops.run_bwd_variant(variant, u, dt, Bm, Cm, A, h, dy, dh)
    torch.cuda.synchronize()
    for c, b in zip(counts, before):
        assert c == dict(b, **{variant: b[variant] + 2})
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    want = selective_scan_ref(u, dt, Bm, Cm, A, h)
    want_grads = selective_scan_bwd_ref(u, dt, Bm, Cm, A, h, dy, dh)
    for a, b in zip(out + grads, want + want_grads):
        assert a.shape == b.shape
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-5, err


@pytest.mark.cuda
def test_cuda_autograd_runs_both_kernels():
    """Autograd through the op on the card launches the forward and the
    backward kernel once each, both the ``reg`` variant, and gives the
    plain version's gradient."""
    _cuda()
    arrs = _inputs(11, 2, 40, 64, 16, False)
    req = [t.requires_grad_() for t in _t(arrs[:5], "cuda")]
    before = (ops.selective_scan.launches, ops.selective_scan_bwd.launches)
    variants = [dict(f.variant_launches) for f in (ops.selective_scan,
                                                   ops.selective_scan_bwd)]
    y, h_last = ops.selective_scan(*req)
    got = torch.autograd.grad(y.square().sum() + h_last.sum(), req)
    torch.cuda.synchronize()
    assert (ops.selective_scan.launches,
            ops.selective_scan_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    for f, b in zip((ops.selective_scan, ops.selective_scan_bwd), variants):
        assert f.variant_launches == dict(b, reg=b["reg"] + 1)
    ref = [t.detach().clone().requires_grad_() for t in req]
    y2, h2 = selective_scan_ref(*ref)
    want = torch.autograd.grad(y2.square().sum() + h2.sum(), ref)
    for a, b in zip(got, want):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err <= 1e-5, err
