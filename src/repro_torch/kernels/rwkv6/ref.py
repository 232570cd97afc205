"""Plain PyTorch versions of the RWKV6 recurrence.

Per head, with receptance r_t, key k_t, value v_t, decay w_t in (0, 1)
and bonus u (all vectors of the head dim):

    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

:func:`wkv_ref` is the chunked form of the reference's
``models.rwkv._wkv_chunked``, the function the CUDA kernel computes: the
CPU path of :func:`..ops.wkv6` runs it, and ``chip_smoke.py`` holds the
kernel to it on the card. :func:`wkv_step_ref` is the port of the
reference's step-wise oracle ``kernels/rwkv6/ref.py::rwkv6_ref``, for
the tests.
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u, state0=None, chunk: int = 64):
    """r, k, v, w: (B, S, H, hd), the model's layout; u: (H, hd);
    ``state0``: (B, H, hd, hd) float32 or None (zeros).
    Returns (y (B, S, H, hd) float32, S_last (B, H, hd, hd) float32).

    Computed in float32 over chunks of ``chunk`` tokens, carrying the
    state from chunk to chunk. Within a chunk the pairwise decay
    e^{cum_ex[t] - cum[s]} (s < t) is the product of the two factors
    r·e^{cum_ex - m} and k·e^{m - cum}, with m half the chunk's summed
    log-decay per channel: exact algebra that halves the exponents, so
    float32 holds while that sum stays above about -176 (the reference's
    unscaled e^{-cum} overflows below -88). A ragged tail is padded with
    w = 1 and k = 0, as the reference's Pallas wrapper pads it, so any S
    works (the reference's ``_wkv_chunked`` reshapes S into equal chunks
    and refuses many lengths)."""
    B, S, H, hd = r.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    f32 = torch.float32
    n = -(-S // chunk)
    pad = n * chunk - S

    def chunks(a, fill):
        a = a.to(f32)
        if pad:
            a = torch.cat([a, a.new_full((B, pad, H, hd), fill)], 1)
        return a.reshape(B, n, chunk, H, hd).unbind(1)

    rc, kc, vc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0)
    wc = chunks(w, 1.0)
    u = u.to(f32)
    St = (torch.zeros((B, H, hd, hd), dtype=f32, device=r.device)
          if state0 is None else state0.to(f32))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    eye = torch.eye(chunk, dtype=f32, device=r.device)
    ys = []
    for rx, kx, vx, wx in zip(rc, kc, vc, wc):            # (B, C, H, hd)
        cum = torch.cumsum(torch.log(wx), 1)              # log-decay <= t
        cum_ex = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        tot = cum[:, -1:]                                 # (B, 1, H, hd)
        m = 0.5 * tot
        # inter-chunk: r_t · (decay(0..t-1) ⊙ S)
        y = torch.einsum("bchd,bhde->bche", rx * torch.exp(cum_ex), St)
        att = torch.einsum("bchd,bshd->bhcs", rx * torch.exp(cum_ex - m),
                           kx * torch.exp(m - cum))
        diag = torch.einsum("bchd,hd,bchd->bhc", rx, u, kx)
        att = torch.where(tri, att, 0.0) + diag[..., None] * eye
        y = y + torch.einsum("bhcs,bshe->bche", att, vx)
        # S = decay(all) ⊙ S + Σ_s decay(s+1..end) k_sᵀ v_s
        St = torch.exp(tot[:, 0])[..., None] * St + torch.einsum(
            "bchd,bche->bhde", kx * torch.exp(tot - cum), vx)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S]
    return y, St


def wkv_step_ref(r, k, v, w, u, state0=None):
    """The exact step-wise recurrence, one token at a time.
    r, k, v, w: (B, H, S, hd) float32 (the reference oracle's layout);
    u: (H, hd). Returns (y (B, H, S, hd), S_last (B, H, hd, hd))."""
    B, H, S, hd = r.shape
    St = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if state0 is None else state0)
    ys = []
    for t in range(S):
        kv = torch.einsum("bhd,bhe->bhde", k[:, :, t], v[:, :, t])
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, :, t],
                               St + u[None, :, :, None] * kv))
        St = w[:, :, t, :, None] * St + kv
    return torch.stack(ys, 2), St


__all__ = ["wkv_ref", "wkv_step_ref"]
