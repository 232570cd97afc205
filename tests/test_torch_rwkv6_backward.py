"""The RWKV6 recurrence's backward: the plain version ``wkv_bwd_ref``, the
staged version ``wkv_bwd_staged_ref`` (the ``mma`` kernel's stages), the
custom ops ``repro_torch::wkv6`` / ``repro_torch::wkv6_bwd``, the routing
between the two backward kernels and, on a card, the kernels
``csrc/rwkv6_bwd_mma.cu`` and ``csrc/rwkv6_bwd.cu``.

On the CPU the plain backward is held to ``torch.autograd`` of the plain
forward ``wkv_ref`` and to ``jax.vjp`` of the reference's ``_wkv_chunked``
(at lengths it takes: equal chunks), the staged version (in float64 and
float32) to both, and the ops' CPU autograd to both, on the same seeded
numpy inputs. Tolerance: 2e-5 x max(1, max |ref|) per gradient; the sides
differ by rounding in other orders, ~5e-7 of the scale here (5e-6 for dw
at the |tot| = 150 edge). The ``cuda``-marked tests hold both kernels to
the plain version on the card:
``python -m pytest -m cuda tests/test_torch_rwkv6_backward.py``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.rwkv6 import ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import (  # noqa: E402
    wkv_bwd_ref, wkv_bwd_staged_ref, wkv_ref)

GATE = 2e-5
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


#: the summed log-decay of a chunk at the edge of the kernels' stated range
EDGE_TOT = 150.0


def _inputs(seed, B, S, H, hd, state=True, decay="test", chunk=None):
    """The reference test's distributions (r, v ~ N(0, 1), k ~ 0.3 N,
    u ~ 0.1 N, w = exp(-exp(0.5 N - 2)); ``decay="model"``: the model's at
    init, w = exp(-exp(-6 + 0.05 N)); ``decay="edge"``: w = exp(-EDGE_TOT
    / chunk + 0.01 N), each chunk's summed log-decay near -EDGE_TOT),
    state0 and the cotangents dy, dS ~ N(0, 1), as numpy float32."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    r, k, v = n(B, S, H, hd), n(B, S, H, hd) * 0.3, n(B, S, H, hd)
    if decay == "test":
        w = np.exp(-np.exp(n(B, S, H, hd) * 0.5 - 2.0))
    elif decay == "edge":
        w = np.exp(-EDGE_TOT / chunk + 0.01 * n(B, S, H, hd))
    else:
        w = np.exp(-np.exp(-6.0 + 0.05 * n(B, S, H, hd)))
    u = n(H, hd) * 0.1
    s0 = n(B, H, hd, hd) if state else None
    return (r, k, v, w.astype(np.float32), u, s0, n(B, S, H, hd),
            n(B, H, hd, hd))


def _t(a, dtype=torch.float32, device="cpu"):
    return None if a is None else \
        torch.from_numpy(a).to(device=device, dtype=dtype)


def _close(got, want, names=NAMES, extra=0.0):
    """Each gradient within GATE x max(1, max |want|) (+ ``extra`` x max
    |want| for one rounding of the output)."""
    for name, a, b in zip(names, got, want):
        a = np.asarray(a.detach().float().cpu() if hasattr(a, "detach")
                       else a, dtype=np.float64)
        b = np.asarray(b.detach().float().cpu() if hasattr(b, "detach")
                       else b, dtype=np.float64)
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= GATE * max(1.0, scale) + extra * scale, \
            f"{name}: max |diff| {err:.3g}, max |ref| {scale:.3g}"


def _autograd(fn, args, dy, ds):
    """Gradients of <y, dy> + <S_last, dS> w.r.t. r, k, v, w, u (and
    state0 when given) through ``fn``."""
    leaves = [a.clone().requires_grad_() if a is not None else None
              for a in args]
    y, s_last = fn(*leaves)
    wrt = [a for a in leaves if a is not None]
    return torch.autograd.grad((y * dy).sum() + (s_last * ds).sum(), wrt)


CASES = [
    # (B, S, H, hd, chunk, state, decay)
    (2, 37, 2, 16, 16, True, "test"),      # ragged tail
    (1, 128, 2, 64, 32, False, "test"),
    (2, 100, 1, 32, 64, True, "model"),    # one ragged chunk of 64
    (1, 5, 3, 16, 8, True, "test"),        # shorter than a chunk
]


@pytest.mark.parametrize("B,S,H,hd,chunk,state,decay", CASES)
def test_plain_backward_matches_autograd_of_plain_forward(B, S, H, hd,
                                                          chunk, state,
                                                          decay):
    r, k, v, w, u, s0, dy, ds = (_t(a) for a in _inputs(
        B * S + hd, B, S, H, hd, state, decay))
    want = _autograd(lambda *a: wkv_ref(*a, chunk), (r, k, v, w, u, s0),
                     dy, ds)
    got = wkv_bwd_ref(r, k, v, w, u, s0, dy, ds, chunk)
    assert all(g.dtype == torch.float32 for g in got)
    _close(got[:5] + ((got[5],) if state else ()), want)


@pytest.fixture(scope="module")
def jx():
    """The reference's chunked form and JAX (on the CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax = pytest.importorskip("jax")
    from repro.models.rwkv import _wkv_chunked
    return jax, _wkv_chunked


def _reference_vjp(jx, args, chunk):
    """jax.vjp of the reference's ``_wkv_chunked`` at the cotangents."""
    jax, wkv_chunked = jx
    r, k, v, w, u, s0, dy, ds = args
    primals = (r, k, v, w, u) + ((s0,) if s0 is not None else ())

    def f(r, k, v, w, u, s0=None):
        return wkv_chunked(r, k, v, w, u, chunk, s0)
    _, vjp = jax.vjp(f, *primals)
    return [np.asarray(g) for g in vjp((dy, ds))]


# S made of equal chunks (the reference reshapes S and refuses others)
JAX_CASES = [
    # (B, S, H, hd, chunk, state, decay)
    (2, 128, 2, 16, 32, True, "test"),
    (1, 64, 2, 64, 64, False, "model"),
    (1, 16, 3, 32, 64, True, "test"),      # one chunk of 16 (port pads)
]


@pytest.mark.parametrize("B,S,H,hd,chunk,state,decay", JAX_CASES)
def test_plain_backward_matches_reference_vjp(jx, B, S, H, hd, chunk, state,
                                              decay):
    args = _inputs(S + hd, B, S, H, hd, state, decay)
    want = _reference_vjp(jx, args, chunk)
    got = wkv_bwd_ref(*(_t(a) for a in args), chunk)
    _close(got[:5] + ((got[5],) if state else ()), want)


@pytest.mark.parametrize("B,S,H,hd,chunk,state,decay", JAX_CASES)
def test_op_autograd_on_cpu_matches_reference_and_plain(jx, B, S, H, hd,
                                                        chunk, state,
                                                        decay):
    """``wkv6`` differentiated by autograd (the custom op's formula runs
    the ``wkv6_bwd`` op's CPU kernel) against jax.vjp of the reference
    and autograd of the plain forward; no launch is counted."""
    args = _inputs(S * 3 + hd, B, S, H, hd, state, decay)
    r, k, v, w, u, s0, dy, ds = (_t(a) for a in args)
    before = (ops.wkv6.launches, ops.wkv6_bwd.launches)
    got = _autograd(lambda *a: ops.wkv6(*a, chunk=chunk),
                    (r, k, v, w, u, s0), dy, ds)
    assert (ops.wkv6.launches, ops.wkv6_bwd.launches) == before
    _close(got, _reference_vjp(jx, args, chunk))
    _close(got, _autograd(lambda *a: wkv_ref(*a, chunk),
                          (r, k, v, w, u, s0), dy, ds))


# the CPU cases, the |tot| = 150 edge at chunk 16, ragged S, chunk 37
STAGED_CASES = CASES + [
    (1, 64, 2, 16, 16, True, "edge"),
    (2, 131, 2, 16, 16, True, "test"),
    (1, 1000, 2, 32, 64, True, "test"),
    (2, 77, 2, 64, 37, False, "test"),
]


def _reference_takes(S, chunk, decay):
    """Whether the reference's ``_wkv_chunked`` computes this case: it cuts
    S into max(S // chunk, 1) equal chunks, and its unscaled e^{-cum}
    overflows float32 at the edge's decay."""
    return S % max(S // chunk, 1) == 0 and decay != "edge"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,S,H,hd,chunk,state,decay", STAGED_CASES)
def test_staged_backward_matches_plain_and_reference(jx, B, S, H, hd, chunk,
                                                     state, decay, dtype):
    """The ``mma`` kernel's decomposition in plain PyTorch (both state
    walks, then every chunk on its own) against the plain backward and,
    where the reference takes the case, jax.vjp of ``_wkv_chunked``."""
    args = _inputs(S * 5 + hd, B, S, H, hd, state, decay, chunk)
    ts = [_t(a) for a in args]
    got = wkv_bwd_staged_ref(*ts, chunk, dtype=dtype)
    assert all(g.dtype == dtype for g in got)
    picked = got[:5] + ((got[5],) if state else ())
    want = wkv_bwd_ref(*ts, chunk)
    _close(picked, want[:5] + ((want[5],) if state else ()))
    if _reference_takes(S, chunk, decay):
        _close(picked, _reference_vjp(jx, args, chunk))


def test_select_bwd_variant_picks_mma_only_for_bf16_at_hd64():
    assert ops.select_bwd_variant(torch.bfloat16, 64) == "mma"
    for dtype, hd in ((torch.bfloat16, 16), (torch.bfloat16, 32),
                      (torch.float32, 64), (torch.float32, 16)):
        assert ops.select_bwd_variant(dtype, hd) == "fma"
    assert ops.BWD_VARIANTS == ("mma", "fma")
    assert set(ops.wkv6_bwd.variant_launches) == set(ops.BWD_VARIANTS)


def test_run_bwd_variant_rejects_cpu_tensors_and_unknown_names():
    """Naming a kernel never runs the plain version: CPU tensors raise, as
    do an unknown name and a variant that does not take the dtype."""
    r, k, v, w, u, s0, dy, ds = (_t(a) for a in _inputs(4, 1, 12, 2, 64))
    rb, kb, vb = r.bfloat16(), k.bfloat16(), v.bfloat16()
    before = (ops.wkv6_bwd.launches, dict(ops.wkv6_bwd.variant_launches))
    for name in ops.BWD_VARIANTS:
        with pytest.raises(ValueError, match="run on cuda"):
            ops.run_bwd_variant(name, rb, kb, vb, w, u, s0, dy, ds, 8)
    with pytest.raises(ValueError, match="unknown wkv6_bwd variant"):
        ops.run_bwd_variant("wgmma", rb, kb, vb, w, u, s0, dy, ds, 8)
    with pytest.raises(ValueError, match="mma backward takes bfloat16"):
        ops.run_bwd_variant("mma", r, k, v, w, u, s0, dy, ds, 8)
    with pytest.raises(ValueError, match="dy must be"):
        ops.run_bwd_variant("mma", rb, kb, vb, w, u, s0, dy[:, :3], ds, 8)
    assert (ops.wkv6_bwd.launches, ops.wkv6_bwd.variant_launches) == before


def test_ops_pass_opcheck():
    """Schemas, fake kernels and autograd registration of both ops."""
    for state in (True, False):
        r, k, v, w, u, s0, dy, ds = (_t(a) for a in _inputs(
            7, 1, 20, 2, 16, state))
        torch.library.opcheck(torch.ops.repro_torch.wkv6.default,
                              (r, k, v, w, u, s0, 8))
        torch.library.opcheck(torch.ops.repro_torch.wkv6_bwd.default,
                              (r, k, v, w, u, s0, dy, ds, 8))


def test_bwd_wrapper_rejects_bad_cotangents_and_returns_r_dtype():
    r, k, v, w, u, s0, dy, ds = (_t(a) for a in _inputs(3, 1, 12, 2, 16))
    out = ops.wkv6_bwd(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u, s0,
                       dy, ds, 8)
    assert [t.dtype for t in out] == [torch.bfloat16] * 3 + \
        [torch.float32] * 3
    assert [tuple(t.shape) for t in out] == [tuple(r.shape)] * 4 + [
        tuple(u.shape), tuple(s0.shape)]
    with pytest.raises(ValueError, match="dy must be"):
        ops.wkv6_bwd(r, k, v, w, u, s0, dy[:, :3], ds)
    with pytest.raises(TypeError, match="ds_last must be float32"):
        ops.wkv6_bwd(r, k, v, w, u, s0, dy, ds.double())
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.wkv6_bwd(*(t.to("meta") for t in (r, k, v, w, u, s0, dy, ds)))


def test_model_timemix_grads_flow_through_the_op():
    """The model's time mix records one ``wkv6`` node when traced, and
    every parameter it reads gets a finite gradient through the op."""
    import dataclasses

    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.models.rwkv import apply_rwkv_timemix
    cfg = dataclasses.replace(reduced(get_config("rwkv6-7b"), layers=1),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = {name: t[0].detach() for name, t in
         params["periods"]["b0"]["tm"].items() if not name.startswith("cm_")}
    x = torch.randn(2, 9, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    gm = make_fx(lambda x: apply_rwkv_timemix(cfg, p, x)[0])(x)
    wkv = [n for n in gm.graph.nodes if "wkv6" in str(n.target)]
    assert len(wkv) == 1, [str(n.target) for n in gm.graph.nodes]
    leaves = {name: t.clone().requires_grad_() for name, t in p.items()}
    out, _ = apply_rwkv_timemix(cfg, leaves, x)
    grads = torch.autograd.grad(out.square().sum(), list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), name
    assert float(grads[list(leaves).index("u")].abs().max()) > 0


# ----------------------------------------------------------------- the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs there")


CUDA_CASES = [
    # (B, S, H, hd, chunk, dtype, state)
    (1, 2048, 8, 64, 64, torch.bfloat16, True),
    (1, 2048, 8, 64, 64, torch.float32, False),
    (2, 131, 3, 16, 16, torch.float32, True),
    (1, 1000, 2, 32, 64, torch.float32, True),
    (2, 77, 2, 64, 37, torch.bfloat16, False),
    (2, 200, 2, 64, 16, torch.bfloat16, True),     # chunk 16, ragged
    (1, 5, 2, 64, 1, torch.bfloat16, True),        # chunks of one token
    (2, 1, 2, 64, 64, torch.bfloat16, True),       # one token
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk,dtype,state", CUDA_CASES)
def test_cuda_backward_kernel_matches_plain_version(B, S, H, hd, chunk,
                                                    dtype, state):
    """The kernel ``select_bwd_variant`` names through ``wkv6_bwd``, and
    every kernel that takes the case by name through ``run_bwd_variant``
    (``mma`` and ``fma`` in bf16 at hd 64), against the plain backward on
    the same inputs on the card (2e-5 of the scale, bf16 gradients one
    rounding more); a repeated call bit-equal; one launch each."""
    _cuda()
    a = _inputs(S + hd, B, S, H, hd, state)
    r, k, v = (_t(x, dtype, "cuda") for x in a[:3])
    w, u, s0, dy, ds = (_t(x, device="cuda") for x in a[3:])
    want = wkv_bwd_ref(r, k, v, w, u, s0, dy, ds, chunk)
    extra = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    chosen = ops.select_bwd_variant(dtype, hd)
    names = ops.BWD_VARIANTS if chosen == "mma" else (chosen,)
    for name in (None,) + names:
        counts = ops.wkv6_bwd.variant_launches
        before = (ops.wkv6_bwd.launches, counts[name or chosen])
        if name is None:
            got = ops.wkv6_bwd(r, k, v, w, u, s0, dy, ds, chunk)
            again = ops.wkv6_bwd(r, k, v, w, u, s0, dy, ds, chunk)
        else:
            got = ops.run_bwd_variant(name, r, k, v, w, u, s0, dy, ds, chunk)
            again = ops.run_bwd_variant(name, r, k, v, w, u, s0, dy, ds,
                                        chunk)
        torch.cuda.synchronize()
        assert (ops.wkv6_bwd.launches, counts[name or chosen]) == (
            before[0] + 2, before[1] + 2), name
        assert all(torch.equal(x, y) for x, y in zip(got, again)), name
        _close(got[:3], want[:3], NAMES[:3], extra)
        _close(got[3:], want[3:], NAMES[3:])


@pytest.mark.cuda
def test_cuda_autograd_runs_the_backward_kernel():
    """``wkv6`` on CUDA tensors that need a gradient: autograd launches the
    forward and the backward kernel once each, and its gradients are the
    plain backward's."""
    _cuda()
    a = _inputs(5, 1, 300, 4, 64)
    r, k, v, w, u, s0, dy, ds = (_t(x, device="cuda") for x in a)
    before = (ops.wkv6.launches, ops.wkv6_bwd.launches)
    got = _autograd(lambda *x: ops.wkv6(*x), (r, k, v, w, u, s0), dy, ds)
    torch.cuda.synchronize()
    assert (ops.wkv6.launches, ops.wkv6_bwd.launches) == (before[0] + 1,
                                                          before[1] + 1)
    _close(got, wkv_bwd_ref(r, k, v, w, u, s0, dy, ds))
