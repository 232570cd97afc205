"""The port's RWKV6 recurrence against the JAX reference.

On the CPU the port's wrapper runs its plain version ``wkv_ref``; these
tests hold it to the reference's Pallas kernel (interpret mode), its
step-wise oracle ``rwkv6_ref`` and the model's ``_wkv_chunked``, on the
same seeded numpy inputs. An emulation of the tensor-core kernel's
arithmetic (``rwkv6_mma.cu``: 3xTF32 products, the e^m folding) holds its
precision scheme to the gate ``chip_smoke.py`` applies on the card. The
CUDA kernels themselves are held to the plain version by the
``cuda``-marked tests, which run only where a card is present (and by
``chip_smoke.py``).

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
    variants = dict(ops.wkv6.variant_launches)
    y, s_last = ops.wkv6(r, k, v, w, u, s0)     # CPU: the plain version
    assert ops.wkv6.launches == before
    assert ops.wkv6.variant_launches == variants
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
    assert ops.wkv6.variant_launches == variants


# chip_smoke.py's gate on the card: max |out - plain| <= 2e-5 x
# max(1, max |plain|), for y and the final state each
RWKV_GATE = 2e-5


def _gate(out, plain) -> float:
    """max |out - plain| over the gate's allowance (holds while <= 1)."""
    out, plain = _np(out), _np(plain)
    return float(np.abs(out - plain).max()
                 / (RWKV_GATE * max(1.0, float(np.abs(plain).max()))))


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits
    to the magnitude's bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, passes: int, b_exact: bool = False):
    """a @ b as the kernel's mma.sync products form it: float32 sums of
    TF32 products. passes=3: hi.hi + hi.lo + lo.hi of the split x = hi +
    lo (lo = tf32(x - hi)); with ``b_exact`` (b is bf16, exact in TF32)
    two passes, hi.b + lo.b; passes=1: one TF32 product."""
    if passes == 1:
        return _tf32(a) @ (b if b_exact else _tf32(b))
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    if b_exact:
        return a_lo @ b + a_hi @ b
    b_hi = _tf32(b)
    b_lo = _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mma_kernel_emulated(r, k, v, w, u, s0, chunk=64, passes=3):
    """The arithmetic of ``rwkv6_mma.cu`` in PyTorch, chunk by chunk:
    log2-scaled prefix sums; Rn = r 2^{cum_ex - m}, Kn = k 2^{m - cum}
    with m half the chunk's total; y = Rn (e^m S) + A v with A the lower
    part of Rn Kn^T plus the bonus term; S <- e^m (e^m S + Kn^T v). The
    products through :func:`_mm` with ``passes``."""
    B, S, H, hd = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def chunks(a, fill):
        a = a.float().transpose(1, 2)                     # (B, H, S, hd)
        if pad:
            a = torch.cat([a, a.new_full((B, H, pad, hd), fill)], 2)
        return a.reshape(B, H, n, chunk, hd).unbind(2)
    St = s0.clone()
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril(-1)
    eye = torch.eye(chunk)
    ys = []
    for rx, kx, vx, wx in zip(chunks(r, 0.0), chunks(k, 0.0),
                              chunks(v, 0.0), chunks(w, 1.0)):
        cum = torch.cumsum(torch.log2(wx), 2)
        cum_ex = torch.cat([torch.zeros_like(cum[:, :, :1]),
                            cum[:, :, :-1]], 2)
        m = 0.5 * cum[:, :, -1:]
        rn, kn = rx * torch.exp2(cum_ex - m), kx * torch.exp2(m - cum)
        em = torch.exp2(m)[:, :, 0, :, None]              # (B, H, hd, 1)
        s_scaled = em * St
        att = _mm(rn, kn.transpose(-1, -2), passes)
        diag = (rx * u[None, :, None] * kx).sum(-1)
        att = torch.where(tri, att, 0.0) + diag[..., None] * eye
        ys.append(_mm(rn, s_scaled, passes)
                  + _mm(att, vx, passes, b_exact=True))
        St = em * (s_scaled + _mm(kn.transpose(-1, -2), vx, passes,
                                  b_exact=True))
    return torch.cat(ys, 2)[:, :, :S].transpose(1, 2), St


def _card_inputs(seed, B, S, H, hd, decay):
    """``chip_smoke.py``'s two decay draws at its bf16 prefill case, in
    numpy: r, v ~ N(0, 1), u ~ 0.1 N, state0 ~ N(0, 1); ``test``: k ~ 0.3
    N, w = exp(-exp(0.5 N - 2)); ``model`` (rwkv6-7b at init): k ~ N,
    w = exp(-exp(-6 + 0.05 N)). r, k, v rounded to bf16."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    r, k, v = n(B, S, H, hd), n(B, S, H, hd), n(B, S, H, hd)
    if decay == "test":
        k = k * 0.3
        w = np.exp(-np.exp(n(B, S, H, hd) * 0.5 - 2.0))
    else:
        w = np.exp(-np.exp(-6.0 + 0.05 * n(B, S, H, hd)))
    u, s0 = n(H, hd) * 0.1, n(B, H, hd, hd)
    return (*(_t(a, "bfloat16") for a in (r, k, v)),
            *(_t(np.asarray(a, np.float32)) for a in (w, u, s0)))


@pytest.mark.parametrize("decay", ["test", "model"])
def test_mma_kernel_3xtf32_arithmetic_meets_the_card_gate(decay):
    """The tensor-core kernel's precision scheme, emulated at S=1024,
    hd=64, bf16 r, k, v and a random state: 3xTF32 (two passes where v
    is an operand) stays well inside the gate (about 0.02 of it)."""
    args = _card_inputs(7, 2, 1024, 4, 64, decay)
    y, s_last = _mma_kernel_emulated(*args, passes=3)
    y_ref, s_ref = wkv_ref(*args)
    assert _gate(y, y_ref) <= 0.1 and _gate(s_last, s_ref) <= 0.1


@pytest.mark.parametrize("decay", ["test", "model"])
def test_one_tf32_pass_per_product_misses_the_card_gate(decay):
    """Why the kernel splits its operands: one TF32 product per term
    misses the gate (by 10-20x) on y and on the state."""
    args = _card_inputs(7, 2, 1024, 4, 64, decay)
    y, s_last = _mma_kernel_emulated(*args, passes=1)
    y_ref, s_ref = wkv_ref(*args)
    assert _gate(y, y_ref) > 1 and _gate(s_last, s_ref) > 1


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -20,
                      -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 1 - 2.0 ** -12])
    want = torch.tensor([1 + 2.0 ** -10, 1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                         1 + 2.0 ** -9, 1.0])
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("dtype,hd,variant", [
    ("bfloat16", 64, "mma"), ("bfloat16", 32, "fma"), ("bfloat16", 16, "fma"),
    ("float32", 64, "fma"), ("float32", 32, "fma"), ("bfloat16", 128, "fma")])
def test_select_variant(dtype, hd, variant):
    assert ops.select_variant(getattr(torch, dtype), hd) == variant


def test_cp_async_layout_check_names_the_misaligned_tensor():
    """The mma kernel's 16-byte rule, on CPU tensors: a model-layout
    tensor and 16-byte-aligned views of a wider one pass; a base or a
    stride off by an element raises ValueError naming the tensor."""
    B, S, H, hd = 2, 5, 4, 64
    r = torch.zeros(B, S, H, hd, dtype=torch.bfloat16)
    qkv = torch.zeros(B, S, 3, H, hd, dtype=torch.bfloat16)
    w = torch.zeros(B, S, H, hd)
    ops.check_cp_async_layout(r=r, k=qkv[:, :, 1], v=qkv[:, :, 2], w=w)
    flat = torch.zeros(B * S * H * hd + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k starts at .* not 16-byte"):
        ops.check_cp_async_layout(r=r, k=flat[1:].view(B, S, H, hd))
    odd = torch.zeros(B, S, H, hd + 1, dtype=torch.bfloat16)[..., :hd]
    with pytest.raises(ValueError, match="v strides"):
        ops.check_cp_async_layout(r=r, v=odd)
    wide = torch.zeros(B, S, H + 1, hd)[:, :, :H, :]
    ops.check_cp_async_layout(w=wide)      # 256-byte rows: aligned
    with pytest.raises(ValueError, match="w strides"):
        ops.check_cp_async_layout(w=torch.zeros(B, S, H, hd + 2)[..., :hd])


def test_run_variant_refuses_what_its_kernel_cannot_take():
    r, k, v, w, u, _ = (_t(a) for a in _inputs(3, 1, 8, 2, 64))
    before = (ops.wkv6.launches, dict(ops.wkv6.variant_launches))
    with pytest.raises(ValueError, match="unknown wkv6 variant"):
        ops.run_variant("wgmma", r, k, v, w, u)
    with pytest.raises(ValueError, match="mma kernel takes bfloat16"):
        ops.run_variant("mma", r, k, v, w, u)
    rb, kb, vb = (t.bfloat16() for t in (r, k, v))
    for variant in ops.VARIANTS:
        with pytest.raises(ValueError, match="run on cuda"):
            ops.run_variant(variant, rb, kb, vb, w, u)
    assert (ops.wkv6.launches, ops.wkv6.variant_launches) == before


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _variants(dtype, hd):
    """The kernels that take this dtype and head dim."""
    return [v for v in ops.VARIANTS
            if v == "fma" or ops.select_variant(getattr(torch, dtype), hd)
            == v]


def _hold(variant, outs, refs):
    """A kernel's (y, S_last) against the plain version's, element by
    element within TOL32; the mma kernel's 3xTF32 sums within the card
    gate as well."""
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(_np(out), _np(ref), **TOL32,
                                   err_msg=variant)
        if variant == "mma":
            assert _gate(out, ref) <= 1, variant


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,chunk,dtype", RWKV_CASES + [
    (2, 3, 1000, 64, 64, "bfloat16"), (1, 2, 131, 16, 1, "float32"),
    (1, 2, 130, 64, 32, "bfloat16"), (2, 1, 77, 64, 16, "bfloat16"),
    (2, 2, 1, 64, 64, "bfloat16")])
@pytest.mark.parametrize("state", [False, True])
def test_cuda_kernel_matches_plain_version(B, H, S, hd, chunk, dtype,
                                           state):
    """Each kernel that takes the case, through ``run_variant``, and the
    one ``wkv6`` selects, each within TOL32 of the plain version, element
    by element, as before; the 3xTF32 tensor-core kernel also within the
    card gate (``RWKV_GATE``, scaled to the output)."""
    _cuda()
    r, k, v, w, u, s0 = (_t(a, dt, "cuda") for a, dt in zip(
        _inputs(S * hd, B, S, H, hd, state),
        [dtype] * 3 + ["float32"] * 3))
    y_ref, s_ref = wkv_ref(r, k, v, w, u, s0, chunk)
    for variant in _variants(dtype, hd):
        before = ops.wkv6.variant_launches[variant]
        y, s_last = ops.run_variant(variant, r, k, v, w, u, s0, chunk)
        torch.cuda.synchronize()
        assert ops.wkv6.variant_launches[variant] == before + 1
        _hold(variant, (y, s_last), (y_ref, s_ref))
    chosen = ops.select_variant(r.dtype, hd)
    before = ops.wkv6.variant_launches[chosen]
    out = ops.wkv6(r, k, v, w, u, s0, chunk)
    torch.cuda.synchronize()
    assert ops.wkv6.variant_launches[chosen] == before + 1
    _hold(chosen, out, (y_ref, s_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(32, "float32"), (64, "bfloat16")])
def test_cuda_kernel_reads_strided_inputs(hd, dtype):
    """r, k, v, w as views of wider tensors, as the model passes them,
    through each kernel that takes them."""
    _cuda()
    B, S, H = 2, 100, 3
    big = [_t(a, dt, "cuda") for a, dt in zip(
        _inputs(1, B, S, 2 * H, hd)[:4], [dtype] * 3 + ["float32"])]
    r, k, v, w = (a[:, :, H:] for a in big)
    u = torch.full((H, hd), 0.1, device="cuda")
    y_ref, s_ref = wkv_ref(r, k, v, w, u)
    for variant in _variants(dtype, hd):
        _hold(variant, ops.run_variant(variant, r, k, v, w, u),
              (y_ref, s_ref))
    with pytest.raises(ValueError, match="contiguous head dim"):
        ops.wkv6(r.transpose(1, 3).contiguous().transpose(1, 3), k, v, w, u)


def test_plain_path_differentiates_on_cpu():
    """On the CPU ``wkv6`` runs the plain recurrence, and autograd
    differentiates it through the plain backward: every input gets a
    finite, non-zero gradient."""
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 20, 2, 16, generator=g, requires_grad=True)
               for _ in range(3))
    w = (0.5 + 0.5 * torch.rand(1, 20, 2, 16, generator=g)
         ).requires_grad_()                       # decays in (0.5, 1)
    u = torch.randn(2, 16, generator=g, requires_grad=True)
    y, s_last = ops.wkv6(r, k, v, w, u, chunk=8)
    grads = torch.autograd.grad(y.square().sum() + s_last.sum(),
                                (r, k, v, w, u))
    for t in grads:
        assert bool(torch.isfinite(t).all()) and float(t.abs().max()) > 0
