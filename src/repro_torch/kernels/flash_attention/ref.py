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


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None, q_offset=0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k: (B, Sk, KV, hd); v: (B, Sk, KV, dv).

    GQA: head h reads KV head h // (H // KV). ``q_offset`` is the
    absolute position of q[:, 0]: an int or a (B,) tensor. Scores are
    float32; the probabilities are rounded to v's dtype before the PV
    product, as the reference does. Rows with every key masked give 0.
    Returns (B, Sq, H, dv) in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = (torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
             + torch.arange(Sq, device=q.device)[None, :])
    qp = q_pos[:, None, None, :, None]                  # (B|1,1,1,Sq,1)
    kp = torch.arange(Sk, device=q.device)[None, None, None, None, :]
    mask = torch.ones((), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


__all__ = ["flash_attention_ref"]
