"""Plain PyTorch version of the flash-attention kernel (O(S²) memory).

The same function as the CUDA kernel: the port of the reference's
``models.layers._plain_gqa``, with ``q_offset`` and ``softcap``. The CPU
path of :func:`..ops.flash_attention` runs it, the tests compare the
reference against it, and ``chip_smoke.py`` holds the kernel to it on
the card. The model's decode path (one query token) calls it directly.
"""
from __future__ import annotations

import math

import torch


def _mask(Sq: int, Sk: int, causal: bool, window, q_offset, device):
    """Which (query, key) pairs are visible: (B|1, 1, 1, Sq, Sk) bool."""
    q_pos = (torch.as_tensor(q_offset, device=device).reshape(-1, 1)
             + torch.arange(Sq, device=device)[None, :])
    qp = q_pos[:, None, None, :, None]                  # (B|1,1,1,Sq,1)
    kp = torch.arange(Sk, device=device)[None, None, None, None, :]
    mask = torch.ones((), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None, q_offset=0,
                        softcap: float = 0.0, return_lse: bool = False):
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, dv).

    GQA: head h reads KV head h // (H // KV). ``q_offset`` is the
    absolute position of q[:, 0]: an int or a (B,) tensor. Scores are
    float32; the probabilities are rounded to v's dtype before the PV
    product, as the reference does. Rows with every key masked give 0.
    Returns (B, Sq, H, dv) in q's dtype; with ``return_lse`` also each
    row's log-sum-exp over its scaled (soft-capped) visible scores,
    float32 (B, H, Sq), +inf for a row with every key masked (what the
    forward kernels write for the backward)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(_mask(Sq, Sk, causal, window, q_offset, q.device), s,
                    float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(lse == float("-inf"), float("inf"), lse)
    return out, lse.reshape(B, H, Sq)


def flash_attention_bwd_ref(dout, q, k, v, *, causal: bool = True,
                            window: int | None = None, q_offset=0,
                            softcap: float = 0.0):
    """Plain version of the backward kernel: (dq, dk, dv), the
    vector-Jacobian product of :func:`flash_attention_ref` at (q, k, v)
    with the cotangent ``dout`` (B, Sq, H, dv), each in its input's
    dtype, written out in the order autograd takes it (and with the
    same roundings: P and dP pass through v's dtype):

        dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(P o dP)),
        dQ = dS K scale,  dK = dS^T Q scale,

    dS times (1 - tanh^2) under a softcap. A row whose every key is
    masked gets zero gradients."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv_ = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    s = torch.where(_mask(Sq, Sk, causal, window, q_offset, q.device), s,
                    float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    do = dout.to(q.dtype).reshape(B, Sq, KV, G, dv_).float()
    dv = torch.einsum("bkgqs,bqkgd->bskd", p.to(v.dtype).float(), do)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, v.float())
    dp = dp.to(v.dtype).float()
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if softcap > 0:
        ds = ds * (1 - t * t)
    ds = ds * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


__all__ = ["flash_attention_bwd_ref", "flash_attention_ref"]
