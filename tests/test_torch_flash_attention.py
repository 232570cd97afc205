"""The port's flash attention against the JAX reference.

On the CPU the port's wrapper runs its plain version; these tests hold
that plain version to the JAX Pallas kernel (interpret mode) and to the
reference's own oracles, on the same seeded numpy inputs, and check the
wrapper's choice of kernel and its TMA layout rule, which need no card.
The CUDA kernels themselves are held to the plain version by the
``cuda``-marked tests, which run only where a card is present (and by
``chip_smoke.py``).

JAX is imported by the fixture that needs it, so the ``cuda`` tests also
run on a machine that has a card and no JAX:
``python -m pytest -m cuda tests/test_torch_flash_attention.py``.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one thread each keeps the parallel test workers from
# contending for the cores
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402

# the reference's cases and tolerances (tests/test_kernels.py)
FLASH_CASES = [
    # (B, H, KV, S, hd, causal, window, dtype)
    (2, 4, 2, 256, 64, True, None, "float32"),
    (1, 4, 4, 128, 128, False, None, "float32"),   # MHA, bidirectional
    (2, 8, 2, 256, 64, True, 64, "float32"),       # sliding window
    (1, 2, 1, 100, 80, True, None, "float32"),     # MQA, ragged dims
    (1, 4, 2, 128, 64, True, None, "bfloat16"),
    (1, 2, 2, 64, 32, True, 16, "bfloat16"),
    (2, 2, 1, 192, 64, True, 128, "float32"),      # window > block
    (1, 4, 4, 100, 192, True, None, "float32"),    # MLA's nope + rope
    (1, 2, 2, 128, 192, True, None, "bfloat16"),
    (1, 4, 4, 128, 80, False, None, "float32"),    # hubert's hd, encoder
    (1, 4, 4, 128, 80, False, None, "bfloat16"),
]


@pytest.fixture(scope="module")
def jx():
    """The reference's attention functions (JAX on the CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref
    from repro.models.layers import _plain_gqa
    return types.SimpleNamespace(jnp=jnp, flash_attention=flash_attention,
                                 attention_ref=attention_ref,
                                 plain_gqa=_plain_gqa)


def _tol(dtype: str) -> dict:
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _inputs(seed, B, H, KV, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32))


def _torch(arrays, dtype: str, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
            for a in arrays]


def _both(jx, arrays, dtype: str):
    """The same arrays as JAX arrays and as torch tensors, both rounded
    to ``dtype`` (round-to-nearest-even in both frameworks)."""
    jnp = jx.jnp
    return ([jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays],
            _torch(arrays, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", FLASH_CASES)
def test_flash_attention_matches_jax_kernel(jx, B, H, KV, S, hd, causal,
                                            window, dtype):
    (jq, jk, jv), (q, k, v) = _both(jx, _inputs(S * hd, B, H, KV, S, S, hd),
                                    dtype)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == (B, S, H, hd) and out.dtype == q.dtype
    pallas = jx.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=64, block_k=64, interpret=True)
    f32 = jx.jnp.float32
    oracle = jx.attention_ref(
        *(a.transpose(0, 2, 1, 3).astype(f32) for a in (jq, jk, jv)),
        causal=causal, window=window).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(oracle), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hd80_non_causal_matches_plain_gqa(jx, dtype):
    """hubert-xlarge's attention (hd 80, every key visible, MHA) on the
    CPU: the op against the reference's ``_plain_gqa``, ragged S."""
    (jq, jk, jv), (q, k, v) = _both(jx, _inputs(80, 2, 4, 4, 70, 70, 80),
                                    dtype)
    out = ops.flash_attention(q, k, v, causal=False)
    ref = jx.plain_gqa(jq, jk, jv, causal=False, window=None, q_offset=0)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("Sq,Sk,q_offset,softcap,window,dtype", [
    (16, 64, 48, 0.0, None, "float32"),       # a prompt continued at 48
    (16, 64, 48, 30.0, None, "float32"),      # plus a soft cap
    (8, 40, 20, 5.0, 12, "float32"),          # offset + window + cap
    (16, 64, 40, 20.0, None, "bfloat16"),
])
def test_flash_attention_offset_softcap_match_plain_gqa(jx, Sq, Sk, q_offset,
                                                        softcap, window,
                                                        dtype):
    """The two arguments the reference's Pallas dispatch drops reach the
    port's attention, with the reference's plain-path semantics."""
    (jq, jk, jv), (q, k, v) = _both(
        jx, _inputs(Sq + Sk, 2, 4, 2, Sq, Sk, 32), dtype)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              q_offset=q_offset, softcap=softcap)
    ref = jx.plain_gqa(jq, jk, jv, causal=True, window=window,
                       q_offset=q_offset, softcap=softcap)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


def test_plain_version_per_row_offsets_match_plain_gqa(jx):
    """Decode: one query token per row, each row at its own position."""
    (jq, jk, jv), (q, k, v) = _both(jx, _inputs(5, 3, 4, 1, 1, 24, 16),
                                    "float32")
    pos = np.array([3, 17, 23], np.int32)
    out = flash_attention_ref(q, k, v, causal=True, window=None,
                              q_offset=torch.from_numpy(pos))
    ref = jx.plain_gqa(jq, jk, jv, causal=True, window=None,
                       q_offset=jx.jnp.asarray(pos))
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", FLASH_CASES)
def test_forward_lse_matches_jax_at_the_reference_cases(jx, B, H, KV, S, hd,
                                                        causal, window,
                                                        dtype):
    """The row log-sum-exp the forward returns with ``return_lse`` (the
    backward's input) against a logsumexp of the same scores, scaled and
    masked as the reference's plain path does, in ``jax.numpy`` on the
    same (rounded) inputs, in float32: 2e-5."""
    (jq, jk, _), (q, k, v) = _both(jx, _inputs(S + hd, B, H, KV, S, S, hd),
                                   dtype)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    jnp = jx.jnp
    f32 = jnp.float32
    s = jnp.einsum("bqkgd,bskd->bkgqs",
                   jq.astype(f32).reshape(B, S, KV, H // KV, hd),
                   jk.astype(f32)) / np.sqrt(hd)
    pos = jnp.arange(S)
    mask = jnp.ones((S, S), dtype=bool)
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    import jax
    want = jax.scipy.special.logsumexp(jnp.where(mask, s, -jnp.inf),
                                       axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(
        B, H, S), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(_np(out), _np(ops.flash_attention(
        q, k, v, causal=causal, window=window)))


def test_fully_masked_rows_have_infinite_lse():
    """A row that sees no key: output 0, LSE +inf (so that the backward's
    P of that row is exp(s - inf) = 0)."""
    q, k, v = _torch(_inputs(1, 1, 2, 2, 4, 8, 16), "float32")
    out, lse = ops.flash_attention(q, k, v, causal=True, q_offset=-8,
                                   return_lse=True)
    assert torch.count_nonzero(out) == 0
    assert bool(torch.isposinf(lse).all())
    _, lse = ops.flash_attention(q, k, v, causal=True, q_offset=-2,
                                 return_lse=True)
    assert bool(torch.isposinf(lse[:, :, :2]).all())
    assert bool(torch.isfinite(lse[:, :, 2:]).all())


def test_fully_masked_rows_are_zero():
    q, k, v = _torch(_inputs(1, 1, 2, 2, 4, 8, 16), "float32")
    # q_offset -8: every query sits before every key
    out = ops.flash_attention(q, k, v, causal=True, q_offset=-8)
    assert torch.count_nonzero(out) == 0


def test_wrapper_rejects_bad_inputs_and_counts_only_kernel_launches():
    q, k, v = _torch(_inputs(2, 1, 4, 2, 8, 8, 16), "float32")
    before = ops.flash_attention.launches
    ops.flash_attention(q, k, v)                   # CPU: plain version
    assert ops.flash_attention.launches == before
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.flash_attention(q, k[:, :, :, :8], v)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k.double(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", FLASH_CASES)
def test_cuda_kernel_matches_plain_version(B, H, KV, S, hd, causal, window,
                                           dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _torch(_inputs(S * hd, B, H, KV, S, S, hd), dtype, "cuda")
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,causal,window,dtype", FLASH_CASES)
def test_cuda_kernel_lse_matches_plain_version(B, H, KV, S, hd, causal,
                                               window, dtype):
    """Both forward kernels' LSE against the plain version's on the same
    inputs: scores in float32 in both, summed in another order, and the
    sm90 kernel's exp2 is the hardware's approximation (2^-22 relative):
    1e-4 absolute on values of a few units."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _torch(_inputs(S + hd, B, H, KV, S, S, hd), dtype, "cuda")
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    _, want = flash_attention_ref(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(lse), _np(want), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,q_offset,softcap,window,dtype", [
    (16, 64, 48, 30.0, None, "float32"),
    (8, 40, 20, 5.0, 12, "float32"),
    (300, 300, 0, 0.0, None, "bfloat16"),      # kv as a strided view
])
def test_cuda_kernel_offset_softcap_strides(Sq, Sk, q_offset, softcap,
                                            window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _torch(_inputs(Sq, 2, 4, 2, Sq, Sk + 8, 128), dtype, "cuda")
    k, v = k[:, :Sk], v[:, :Sk]
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              q_offset=q_offset, softcap=softcap)
    ref = flash_attention_ref(q, k, v, causal=True, window=window,
                              q_offset=q_offset, softcap=softcap)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dtype))


@pytest.mark.parametrize("dtype,hd,dv,variant", [
    ("bfloat16", 64, 64, "sm90"),
    ("bfloat16", 128, 128, "sm90"),
    ("bfloat16", 32, 32, "fma"),
    ("bfloat16", 80, 80, "sm90"),      # hubert-xlarge
    ("bfloat16", 192, 128, "sm90"),     # MLA: q/k 128 + 64, v 128
    ("bfloat16", 256, 256, "sm90"),     # gemma3-1b
    ("bfloat16", 192, 192, "fma"),
    ("bfloat16", 128, 64, "fma"),
    ("float32", 64, 64, "fma"),
    ("float32", 128, 128, "fma"),
    ("float32", 192, 128, "fma"),
])
def test_variant_is_chosen_from_dtype_and_head_dim(dtype, hd, dv, variant):
    """sm90 exactly at the bf16 (hd, dv) pairs of SM90_SHAPES."""
    assert ops.select_variant(getattr(torch, dtype), hd, dv) == variant
    assert (variant == "sm90") == (dtype == "bfloat16"
                                   and (hd, dv) in ops.SM90_SHAPES)
    if hd == dv:
        assert ops.select_variant(getattr(torch, dtype), hd) == variant
    assert variant in ops.flash_attention.variant_launches


def test_tma_layout_check_raises_before_any_launch():
    """The sm90 kernel's TMA rules, checked on CPU tensors: the model's
    layouts pass; a view offset by one element and a stride that is not
    a multiple of 16 bytes raise ValueError."""
    x = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16)
    cache = torch.zeros((2, 256, 2, 64), dtype=torch.bfloat16)
    ops.check_tma_layout(q=x, k=cache[:, :100], v=cache[:, 8:40])
    flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + x.numel()].view(x.shape)    # one element in
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.check_tma_layout(q=shifted)
    wide = torch.zeros((2, 64, 4, 68), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        ops.check_tma_layout(v=wide[..., :64])


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,window,q_offset,softcap", [
    (1, 4, 2, 100, 100, 128, None, 0, 0.0),     # ragged S, hd 128
    (1, 4, 2, 32, 96, 64, None, 64, 0.0),       # prefill with a cache
    (1, 4, 2, 128, 128, 64, 40, 0, 0.0),        # window
    (1, 4, 2, 64, 64, 128, None, 0, 30.0),      # soft cap
])
def test_sm90_edges_plain_version_matches_plain_gqa(jx, B, H, KV, Sq, Sk, hd,
                                                    window, q_offset,
                                                    softcap):
    """The edge cases the sm90 kernel is held to on the card, at small
    sizes in bf16: the plain version (what the kernel is compared with)
    against the reference's plain attention."""
    (jq, jk, jv), (q, k, v) = _both(
        jx, _inputs(Sq * hd + Sk, B, H, KV, Sq, Sk, hd), "bfloat16")
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              q_offset=q_offset, softcap=softcap)
    ref = jx.plain_gqa(jq, jk, jv, causal=True, window=window,
                       q_offset=q_offset, softcap=softcap)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol("bfloat16"))


# The sm90 kernel's edges on the card; each is held to the plain version
# within the reference's bf16 tolerance and to the plain version run in
# float32 within one bf16 step (chip_smoke.py's TIGHT gate).
TIGHT = dict(atol=1e-5, rtol=2.0 ** -7)
SM90_CASES = [
    # (B, H, KV, Sq, Sk, hd, causal, window, q_offset, softcap, kv_view)
    (2, 4, 2, 256, 256, 64, True, None, 0, 0.0, False),
    (1, 4, 4, 128, 128, 128, False, None, 0, 0.0, False),
    (2, 8, 2, 256, 256, 64, True, 64, 0, 0.0, False),
    (1, 4, 2, 128, 128, 64, True, None, 0, 0.0, False),
    (2, 2, 1, 192, 192, 64, True, 128, 0, 0.0, False),
    (2, 4, 2, 1000, 1000, 128, True, None, 0, 0.0, False),   # ragged
    (2, 8, 2, 512, 1024, 128, True, None, 512, 0.0, False),  # with a cache
    (2, 8, 2, 1024, 1024, 128, True, 256, 0, 0.0, False),    # window
    (2, 8, 2, 512, 512, 128, True, None, 0, 30.0, False),    # soft cap
    (2, 8, 2, 300, 1000, 128, True, None, 700, 0.0, True),   # k, v views
    (8, 12, 4, 1024, 1024, 64, True, None, 0, 0.0, False),   # repro-lm-100m
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,hd,causal,window,q_offset,softcap,kv_view", SM90_CASES)
def test_cuda_sm90_kernel_edges(B, H, KV, Sq, Sk, hd, causal, window,
                                q_offset, softcap, kv_view):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v = _torch(_inputs(Sq + hd, B, H, KV, Sq, 2 * Sk, hd), "bfloat16",
                     "cuda")
    k, v = (k[:, :Sk], v[:, Sk:]) if kv_view else \
        (k[:, :Sk].contiguous(), v[:, :Sk].contiguous())
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softcap=softcap)
    before = dict(ops.flash_attention.variant_launches)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.variant_launches["sm90"] == \
        before["sm90"] + 1
    ref = flash_attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol("bfloat16"))
    ref32 = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    np.testing.assert_allclose(_np(out), _np(ref32), **TIGHT)


def test_ablations_apply_to_the_sm90_source():
    """Each ablation of the sm90 kernel (``ablate.py``, run on the card)
    finds the text it changes, so the script keeps measuring what it
    says after the kernel is edited."""
    from repro_torch.kernels.flash_attention import ablate
    source = ablate.SOURCE.read_text()
    for name in ablate.ABLATIONS:
        text = ablate.variant_source(name)
        assert (text == source) == (name == "kernel"), name


@pytest.mark.parametrize("variant,dtype,hd,match", [
    ("tiled", "bfloat16", 128, "unknown flash_attention variant"),
    ("sm90", "float32", 128, "sm90 kernel takes bfloat16"),
    ("sm90", "bfloat16", 32, "sm90 kernel takes bfloat16"),
    ("sm90", "bfloat16", 192, "sm90 kernel takes bfloat16"),
    ("fma", "bfloat16", 128, "run on cuda"),
    ("fma", "bfloat16", 192, "run on cuda"),
])
def test_run_variant_refuses_what_its_kernel_cannot_take(variant, dtype, hd,
                                                         match):
    """``run_variant`` raises before any launch: an unknown kernel, the
    sm90 kernel off its (dtype, head dim), a tensor off the card."""
    q, k, v = _torch(_inputs(3, 1, 4, 2, 8, 8, hd), dtype)
    before = ops.flash_attention.launches
    with pytest.raises(ValueError, match=match):
        ops.run_variant(variant, q, k, v)
    assert ops.flash_attention.launches == before
