"""The port's RWKV6 recurrence against the JAX reference.

On the CPU the port's wrapper runs its plain version ``wkv_ref``; these
tests hold it to the reference's Pallas kernel (interpret mode), its
step-wise oracle ``rwkv6_ref`` and the model's ``_wkv_chunked``, on the
same seeded numpy inputs. The CUDA kernel itself is held to the plain
version by the ``cuda``-marked tests, which run only where a card is
present (and by ``chip_smoke.py``).

JAX is imported by the fixture that needs it, so the ``cuda`` tests also
run on a machine that has a card and no JAX:
``python -m pytest -m cuda tests/test_torch_rwkv6.py``.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each keeps the parallel test workers from
# contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels.rwkv6 import ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv_ref, wkv_step_ref  # noqa: E402

# the reference's cases (tests/test_kernels.py)
RWKV_CASES = [
    # (B, H, S, hd, chunk, dtype)
    (2, 2, 128, 64, 32, "float32"),
    (1, 4, 96, 64, 64, "float32"),
    (2, 1, 70, 32, 16, "float32"),    # ragged seq (padding path)
    (1, 2, 64, 64, 64, "bfloat16"),
    (1, 1, 33, 16, 8, "float32"),
]
# float32 against float32: the chunked forms and the step-wise oracle
# compute the same sums in other orders (and the port rescales the decay
# factors by an exact power of e), so they differ by float32 rounding,
# ~1e-6 relative at these sizes; 2e-5 leaves a margin of ten.
TOL32 = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jx():
    """The reference's RWKV6 functions (JAX on the CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.rwkv6.ops import rwkv6
    from repro.kernels.rwkv6.ref import rwkv6_ref
    from repro.models.rwkv import _wkv_chunked
    return types.SimpleNamespace(jnp=jnp, rwkv6=rwkv6, rwkv6_ref=rwkv6_ref,
                                 wkv_chunked=_wkv_chunked)


def _inputs(seed, B, S, H, hd, state=False):
    """The reference test's distributions: r, v ~ N(0, 1), k ~ 0.3 N,
    w = exp(-exp(0.5 N - 2)), u ~ 0.1 N; state0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    r, k, v = n(B, S, H, hd), n(B, S, H, hd) * 0.3, n(B, S, H, hd)
    w = np.exp(-np.exp(n(B, S, H, hd) * 0.5 - 2.0)).astype(np.float32)
    u = n(H, hd) * 0.1
    s0 = n(B, H, hd, hd) if state else None
    return r, k, v, w, u, s0


def _t(a, dtype="float32", device="cpu"):
    return None if a is None else \
        torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _plain(r, k, v, w, u, s0=None, chunk=64, dtype="float32"):
    """wkv_ref on r, k, v in ``dtype``, the rest float32."""
    return wkv_ref(_t(r, dtype), _t(k, dtype), _t(v, dtype), _t(w), _t(u),
                   _t(s0), chunk)


def _oracle(jx, r, k, v, w, u, s0=None):
    """The reference's step-wise oracle, in the model layout."""
    jnp = jx.jnp
    y, s = jx.rwkv6_ref(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                          for a in (r, k, v, w)), jnp.asarray(u),
                        None if s0 is None else jnp.asarray(s0))
    return np.asarray(y).transpose(0, 2, 1, 3), np.asarray(s)


@pytest.mark.parametrize("B,H,S,hd,chunk,dtype", RWKV_CASES)
def test_plain_version_matches_pallas_kernel(jx, B, H, S, hd, chunk, dtype):
    r, k, v, w, u, _ = _inputs(S * hd, B, S, H, hd)
    jnp = jx.jnp
    jdt = getattr(jnp, dtype)
    # the reference test casts every input to dtype, w and u included:
    # both sides get those same rounded values (w and u as float32 here)
    rj, kj, vj, wj, uj = (jnp.asarray(a).astype(jdt)
                          for a in (r, k, v, w, u))
    pallas = jx.rwkv6(rj, kj, vj, wj, uj, chunk=chunk, interpret=True)
    assert pallas.dtype == jdt
    w, u = (np.array(a.astype(jnp.float32)) for a in (wj, uj))
    y, _ = _plain(r, k, v, w, u, chunk=chunk, dtype=dtype)
    assert y.shape == (B, S, H, hd) and y.dtype == torch.float32
    # bf16: the Pallas kernel computes in float32 and rounds its output
    # to bf16, by at most half a bf16 step: 2^-8 of the value at the
    # bottom of a binade. One step, 2^-7, covers it
    tol = dict(atol=1e-5, rtol=2.0 ** -7) if dtype == "bfloat16" else TOL32
    np.testing.assert_allclose(_np(y), _np(pallas), **tol)


@pytest.mark.parametrize("B,H,S,hd,chunk", [
    (2, 2, 128, 64, 32), (2, 1, 70, 32, 16), (1, 2, 131, 16, 64),
    (1, 1, 33, 16, 8), (2, 3, 5, 32, 64)])
def test_plain_version_with_state_matches_step_oracle(jx, B, H, S, hd,
                                                      chunk):
    args = _inputs(S + hd, B, S, H, hd, state=True)
    y, s_last = _plain(*args, chunk=chunk)
    y_ref, s_ref = _oracle(jx, *args)
    np.testing.assert_allclose(_np(y), y_ref, **TOL32)
    np.testing.assert_allclose(_np(s_last), s_ref, **TOL32)


@pytest.mark.parametrize("S", [64, 128, 130])
def test_plain_version_matches_model_chunked_form(jx, S):
    """The model's ``_wkv_chunked`` with ``state0``, at lengths it takes
    (it cuts S into S // 64 equal chunks: 130 runs as two of 65)."""
    r, k, v, w, u, s0 = _inputs(S, 2, S, 2, 16, state=True)
    jnp = jx.jnp
    y_ref, s_ref = jx.wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w)),
                                  jnp.asarray(u), chunk=64,
                                  state0=jnp.asarray(s0))
    y, s_last = _plain(r, k, v, w, u, s0)
    np.testing.assert_allclose(_np(y), np.asarray(y_ref), **TOL32)
    np.testing.assert_allclose(_np(s_last), np.asarray(s_ref), **TOL32)


@pytest.mark.parametrize("S", [131, 1000])
def test_ragged_lengths_the_model_chunked_form_refuses(jx, S):
    """A reference quirk, documented and not copied: ``_wkv_chunked``
    cannot reshape these lengths into equal chunks; the port masks the
    ragged tail and agrees with the step oracle."""
    args = _inputs(S, 1, S, 1, 16, state=True)
    jnp = jx.jnp
    with pytest.raises(TypeError, match="reshape"):
        jx.wkv_chunked(*(jnp.asarray(a) for a in args[:5]), chunk=64,
                       state0=jnp.asarray(args[5]))
    y, s_last = _plain(*args)
    y_ref, s_ref = _oracle(jx, *args)
    np.testing.assert_allclose(_np(y), y_ref, **TOL32)
    np.testing.assert_allclose(_np(s_last), s_ref, **TOL32)


def test_step_port_matches_step_oracle(jx):
    args = _inputs(9, 2, 23, 3, 16, state=True)
    y, s_last = wkv_step_ref(*(_t(a).transpose(1, 2) for a in args[:4]),
                             _t(args[4]), _t(args[5]))
    y_ref, s_ref = _oracle(jx, *args)
    np.testing.assert_allclose(_np(y.transpose(1, 2)), y_ref, **TOL32)
    np.testing.assert_allclose(_np(s_last), s_ref, **TOL32)


def test_chunk_invariance():
    """The chunk is an implementation choice: every chunk gives the same
    y and state (the reference's chunk-invariance test, with a state)."""
    args = _inputs(11, 1, 128, 2, 32, state=True)
    outs = [_plain(*args, chunk=c) for c in (1, 16, 32, 64, 100, 128)]
    for y, s in outs[1:]:
        np.testing.assert_allclose(_np(y), _np(outs[0][0]), **TOL32)
        np.testing.assert_allclose(_np(s), _np(outs[0][1]), **TOL32)


def test_wrapper_rejects_bad_inputs_and_counts_only_kernel_launches():
    r, k, v, w, u, s0 = (_t(a) for a in _inputs(2, 1, 8, 2, 16, True))
    before = ops.wkv6.launches
    y, s_last = ops.wkv6(r, k, v, w, u, s0)     # CPU: the plain version
    assert ops.wkv6.launches == before
    y_ref, s_ref = wkv_ref(r, k, v, w, u, s0)
    assert torch.equal(y, y_ref) and torch.equal(s_last, s_ref)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.wkv6(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match="u must be"):
        ops.wkv6(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="state0 must be"):
        ops.wkv6(r, k, v, w, u, s0[:, :1])
    with pytest.raises(TypeError, match="dtype"):
        ops.wkv6(r, k.double(), v, w, u)
    with pytest.raises(TypeError, match="w must be float32"):
        ops.wkv6(r, k, v, w.bfloat16(), u)
    with pytest.raises(TypeError, match="state0 must be float32"):
        ops.wkv6(r, k, v, w, u, s0.double())
    with pytest.raises(ValueError, match="chunk"):
        ops.wkv6(r, k, v, w, u, chunk=0)
    with pytest.raises(ValueError, match="at least one token"):
        ops.wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.wkv6(*(t.to("meta") for t in (r, k, v, w, u)))
    assert ops.wkv6.launches == before


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,chunk,dtype", RWKV_CASES + [
    (2, 3, 1000, 64, 64, "bfloat16"), (1, 2, 131, 16, 1, "float32")])
@pytest.mark.parametrize("state", [False, True])
def test_cuda_kernel_matches_plain_version(B, H, S, hd, chunk, dtype,
                                           state):
    _cuda()
    r, k, v, w, u, s0 = (_t(a, dt, "cuda") for a, dt in zip(
        _inputs(S * hd, B, S, H, hd, state),
        [dtype] * 3 + ["float32"] * 3))
    before = ops.wkv6.launches
    y, s_last = ops.wkv6(r, k, v, w, u, s0, chunk)
    torch.cuda.synchronize()
    assert ops.wkv6.launches == before + 1
    y_ref, s_ref = wkv_ref(r, k, v, w, u, s0, chunk)
    np.testing.assert_allclose(_np(y), _np(y_ref), **TOL32)
    np.testing.assert_allclose(_np(s_last), _np(s_ref), **TOL32)


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_inputs():
    """r, k, v, w as views of wider tensors, as the model passes them."""
    _cuda()
    B, S, H, hd = 2, 100, 3, 32
    big = [_t(a, device="cuda") for a in _inputs(1, B, S, 2 * H, hd)[:4]]
    r, k, v, w = (a[:, :, H:] for a in big)
    u = torch.full((H, hd), 0.1, device="cuda")
    y, s_last = ops.wkv6(r, k, v, w, u)
    y_ref, s_ref = wkv_ref(r, k, v, w, u)
    np.testing.assert_allclose(_np(y), _np(y_ref), **TOL32)
    np.testing.assert_allclose(_np(s_last), _np(s_ref), **TOL32)
    with pytest.raises(ValueError, match="contiguous head dim"):
        ops.wkv6(r.transpose(1, 3).contiguous().transpose(1, 3), k, v, w, u)
