"""Plain PyTorch versions of the RWKV6 recurrence.

Per head, with receptance r_t, key k_t, value v_t, decay w_t in (0, 1)
and bonus u (all vectors of the head dim):

    y_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t

:func:`wkv_ref` is the chunked form of the reference's
``models.rwkv._wkv_chunked``, the function the CUDA kernel computes: the
CPU path of :func:`..ops.wkv6` runs it, and ``chip_smoke.py`` holds the
kernel to it on the card. :func:`wkv_bwd_ref` is its backward, written
out chunk by chunk (the CPU path of the backward op, and what
``chip_smoke.py`` holds the backward kernels to);
:func:`wkv_bwd_staged_ref` computes the same in the stages of the ``mma``
backward kernel, for the tests. :func:`wkv_step_ref` is the port of the
reference's step-wise oracle ``kernels/rwkv6/ref.py::rwkv6_ref``, for the
tests.
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
        cum, cum_ex, tot, m = _log_decays(wx)
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


def _log_decays(wx, dim: int = 1):
    """A chunk's inclusive and exclusive log-decay sums, their total and
    half of it, per channel, over the chunk's axis ``dim``: (cum, cum_ex,
    tot (size 1 along ``dim``), m)."""
    cum = torch.cumsum(torch.log(wx), dim)                # log-decay <= t
    cum_ex = torch.cat([torch.zeros_like(cum.narrow(dim, 0, 1)),
                        cum.narrow(dim, 0, cum.shape[dim] - 1)], dim)
    tot = cum.narrow(dim, cum.shape[dim] - 1, 1)
    return cum, cum_ex, tot, 0.5 * tot


def wkv_bwd_ref(r, k, v, w, u, state0, dy, ds_last, chunk: int = 64):
    """The backward of :func:`wkv_ref`: given the cotangents ``dy``
    (B, S, H, hd) of y and ``ds_last`` (B, H, hd, hd) of S_last (either
    may be None: zeros), returns (dr, dk, dv, dw (B, S, H, hd), du
    (H, hd), dstate0 (B, H, hd, hd)), all float32; dstate0 is returned
    also when ``state0`` is None (then it is the gradient of a zero
    state).

    Written out, not autograd: the same chunks, ragged-tail padding
    (w = 1, k = 0) and half-sum factors as :func:`wkv_ref`. The
    chunk-start states are recomputed first; then the chunks are walked
    in reverse, carrying dS (the cotangent of the state leaving the
    chunk). Per chunk, with r̃ = r·e^{cum_ex - m}, k̃ = k·e^{m - cum}
    (A = tril₋₁(r̃ k̃ᵀ), the pairwise decays of r̂ k̂ᵀ for
    r̂ = r·e^{cum_ex}, k̂ = k·e^{-cum}) and k_tail = k·e^{tot - cum}:

        dA   = tril₋₁(dy vᵀ) = dA₂ + b   (b_t = dA[t, t-1], the band)
        dr   = (dA₂ k̃)·e^{cum_ex - m} + b_t k_{t-1}
               + (dy S_inᵀ)·e^{cum_ex} + δ u k
        dk   = (dA₂ᵀ r̃)·e^{m - cum} + b_{s+1} r_{s+1}
               + (v dSᵀ)·e^{tot - cum} + δ u r
        dv   = Aᵀ dy + (r·u·k)_t dy_t + k_tail dS
        du  += Σ_t δ_t r_t k_t,   δ_t = dy_t · v_t
        dS_in = r̂ᵀ dy + diag(e^{tot}) dS

    (the band's pairwise decay e^{cum_ex_t - cum_{t-1}} is exactly 1).
    dlog w_j = Σ_{t>j} (dA₂ k̃)_t r̃_t + (dy S_inᵀ)_t r_t e^{cum_ex_t}
    - Σ_{t≥j} (dA₂ᵀ r̃)_t k̃_t + Σ_{s<j} (v dSᵀ)_s k_tail_s
    + e^{tot} Σ_e S_in dS, and dw = dlog w / w. The pairs (t, t-1) and
    the tail's terms at j ≤ s enter the cum, cum_ex and tot terms with
    opposite signs and cancel exactly, so they are left out rather than
    summed and cancelled in float32: under strong decay they are the
    largest terms, and the rounding they left was up to 7e-4 of max |dw|
    (chunk 16, w ~ 1e-4), against 7e-6 without them.

    Range: the factors e^{±(cum - m)} reach e^{-tot/2}, and the sums
    dA k̃ and dAᵀ r̃ add 64 of them times |dy v| terms, so float32 holds
    while each channel's summed log-decay over a chunk (tot) stays above
    about -150 (e^75 = 3.7e32 leaves a factor of 9e5 for 64 |dA| |k| below
    float32's 3.4e38); the forward's own bound is -176."""
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
    dyc = chunks(dy if dy is not None else torch.zeros_like(r, dtype=f32),
                 0.0)
    u = u.to(f32)
    zeros = torch.zeros((B, H, hd, hd), dtype=f32, device=r.device)
    St = zeros if state0 is None else state0.to(f32)
    states = []
    for kx, vx, wx in zip(kc, vc, wc):
        states.append(St)
        cum, _, tot, _ = _log_decays(wx)
        St = torch.exp(tot[:, 0])[..., None] * St + torch.einsum(
            "bchd,bche->bhde", kx * torch.exp(tot - cum), vx)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    tri2 = tri.tril(-2)
    dS = zeros if ds_last is None else ds_last.to(f32)
    du = torch.zeros_like(u)
    drs, dks, dvs, dws = [], [], [], []
    for i in reversed(range(n)):
        rx, kx, vx, wx, dyx, S_in = rc[i], kc[i], vc[i], wc[i], dyc[i], \
            states[i]
        cum, cum_ex, tot, m = _log_decays(wx)
        e_ex, tail = torch.exp(cum_ex), torch.exp(tot - cum)
        rt = rx * torch.exp(cum_ex - m)
        kt = kx * torch.exp(m - cum)
        k_tail = kx * tail
        A = torch.where(tri, torch.einsum("bchd,bshd->bhcs", rt, kt), 0.0)
        dA = torch.einsum("bche,bshe->bhcs", dyx, vx)
        band = torch.diagonal(dA, -1, 2, 3).permute(0, 2, 1)  # (B, C-1, H)
        dA = torch.where(tri2, dA, 0.0)
        delta = (dyx * vx).sum(-1, keepdim=True)           # (B, C, H, 1)
        diag = torch.einsum("bchd,hd,bchd->bch", rx, u, kx)[..., None]
        G = torch.einsum("bhcs,bshd->bchd", dA, kt)
        Q = torch.einsum("bche,bhde->bchd", dyx, S_in)
        Hs = torch.einsum("bhcs,bchd->bshd", dA, rt)
        P = torch.einsum("bshe,bhde->bshd", vx, dS)
        dr = G * torch.exp(cum_ex - m) + Q * e_ex + delta * u * kx
        dr[:, 1:] += band[..., None] * kx[:, :-1]
        dk = Hs * torch.exp(m - cum) + P * tail + delta * u * rx
        dk[:, :-1] += band[..., None] * rx[:, 1:]
        drs.append(dr)
        dks.append(dk)
        dvs.append(torch.einsum("bhcs,bche->bshe", A, dyx) + diag * dyx
                   + torch.einsum("bshd,bhde->bshe", k_tail, dS))
        du = du + (delta * rx * kx).sum((0, 1))
        # the log-decay: cum_t directly, cum_ex_t = cum_{t-1}, tot = cum_C;
        # the tail's terms as an exclusive prefix sum
        dcum = -(Hs * kt)
        dcum[:, :-1] += (G * rt + Q * rx * e_ex)[:, 1:]
        dcum[:, -1] += torch.exp(tot[:, 0]) * (S_in * dS).sum(-1)
        pk = torch.cumsum(P * k_tail, 1)
        dlogw = dcum.flip(1).cumsum(1).flip(1)
        dlogw[:, 1:] += pk[:, :-1]
        dws.append(dlogw / wx)
        dS = torch.einsum("bchd,bche->bhde", rx * e_ex, dyx) + \
            torch.exp(tot[:, 0])[..., None] * dS

    def joined(parts):
        return torch.cat(parts[::-1], 1)[:, :S]
    return joined(drs), joined(dks), joined(dvs), joined(dws), du, dS


def wkv_bwd_staged_ref(r, k, v, w, u, state0, dy, ds_last,
                       chunk: int = 64, dtype=torch.float32):
    """:func:`wkv_bwd_ref`'s function in the three stages of the ``mma``
    backward kernel (``csrc/rwkv6_bwd_mma.cu``), computed in ``dtype``:

    1. the forward walk: each chunk's start state S_in, from ``state0``;
    2. the backward walk: each chunk's dS (the cotangent of the state it
       leaves), from ``ds_last``, and dstate0. Both recurrences act on
       the state element by element, which is what lets the kernel cut
       them into state tiles;
    3. every chunk's gradients at once, from its own inputs, S_in and dS
       (batched over the chunks): no chain across chunks.

    Same arguments, padding and returns as :func:`wkv_bwd_ref` (in
    ``dtype``); the same cancellation-free log-decay terms. Per chunk, with
    fr = e^{cum_ex - m}, fk = e^{m - cum}, r̃ = r·fr, k̃ = k·fk:
    dr = fr·G + fr·e^m·Q + b_t k_{t-1} + δ u k, dk = fk·Hs + fk·e^m·P
    + b_{s+1} r_{s+1} + δ u r, dv = Aᵀ dy + k̃ (e^m ⊙ dS) + (r·u·k)_t dy_t,
    the kernel's grouping (k_tail = k̃·e^m, r·e^{cum_ex} = r̃·e^m). The
    tests hold it to :func:`wkv_bwd_ref` and to the reference's VJP; the
    main path never calls it."""
    B, S, H, hd = r.shape
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    n = -(-S // chunk)
    pad = n * chunk - S

    def chunks(a, fill):
        a = a.to(dtype)
        if pad:
            a = torch.cat([a, a.new_full((B, pad, H, hd), fill)], 1)
        return a.reshape(B, n, chunk, H, hd)

    rc, kc, vc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0)
    wc = chunks(w, 1.0)
    dyc = chunks(dy if dy is not None else torch.zeros_like(r, dtype=dtype),
                 0.0)
    u = u.to(dtype)
    cum, cum_ex, tot, m = _log_decays(wc, 2)              # (B, n, ·, H, hd)
    e_tot = torch.exp(tot[:, :, 0])[..., None]            # (B, n, H, hd, 1)
    zeros = torch.zeros((B, H, hd, hd), dtype=dtype, device=r.device)

    # 1-2. the walks: S_ws[:, c] = S_in, dS_ws[:, c] = dS of chunk c
    k_tail = kc * torch.exp(tot - cum)
    r_hat = rc * torch.exp(cum_ex)
    St = zeros if state0 is None else state0.to(dtype)
    s_ws = []
    for c in range(n):
        s_ws.append(St)
        St = e_tot[:, c] * St + torch.einsum("bchd,bche->bhde", k_tail[:, c],
                                             vc[:, c])
    dS = zeros if ds_last is None else ds_last.to(dtype)
    ds_ws = [None] * n
    for c in reversed(range(n)):
        ds_ws[c] = dS
        dS = torch.einsum("bchd,bche->bhde", r_hat[:, c], dyc[:, c]) + \
            e_tot[:, c] * dS
    S_in, dS_out = torch.stack(s_ws, 1), torch.stack(ds_ws, 1)

    # 3. every chunk at once
    fr, fk, em = torch.exp(cum_ex - m), torch.exp(m - cum), torch.exp(m)
    rt, kt = rc * fr, kc * fk
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    A = torch.where(tri, torch.einsum("bnchd,bnshd->bnhcs", rt, kt), 0.0)
    dA = torch.einsum("bnche,bnshe->bnhcs", dyc, vc)
    band = torch.diagonal(dA, -1, 3, 4).permute(0, 1, 3, 2)  # (B,n,C-1,H)
    dA2 = torch.where(tri.tril(-2), dA, 0.0)
    delta = (dyc * vc).sum(-1, keepdim=True)
    diag = torch.einsum("bnchd,hd,bnchd->bnch", rc, u, kc)[..., None]
    G = torch.einsum("bnhcs,bnshd->bnchd", dA2, kt)
    Q = torch.einsum("bnche,bnhde->bnchd", dyc, S_in)
    Hs = torch.einsum("bnhcs,bnchd->bnshd", dA2, rt)
    P = torch.einsum("bnshe,bnhde->bnshd", vc, dS_out)
    dr = fr * G + fr * em * Q + delta * u * kc
    dr[:, :, 1:] += band[..., None] * kc[:, :, :-1]
    dk = fk * Hs + fk * em * P + delta * u * rc
    dk[:, :, :-1] += band[..., None] * rc[:, :, 1:]
    dS_em = em.squeeze(2)[..., None] * dS_out             # e^m ⊙ dS, by row
    dv = torch.einsum("bnhcs,bnche->bnshe", A, dyc) + \
        torch.einsum("bnshd,bnhde->bnshe", kt, dS_em) + diag * dyc
    du = (delta * rc * kc).sum((0, 1, 2))
    # the log-decay: cum_t directly, cum_ex_t = cum_{t-1}, tot = cum_C;
    # the tail's terms as an exclusive prefix sum
    dcum = -(Hs * kt)
    dcum[:, :, :-1] += (rt * (G + em * Q))[:, :, 1:]
    dcum[:, :, -1] += e_tot[..., 0] * (S_in * dS_out).sum(-1)
    pk = torch.cumsum(P * kt * em, 2)
    dlogw = dcum.flip(2).cumsum(2).flip(2)
    dlogw[:, :, 1:] += pk[:, :, :-1]
    dw = dlogw / wc

    def joined(a):
        return a.reshape(B, n * chunk, H, hd)[:, :S]
    return joined(dr), joined(dk), joined(dv), joined(dw), du, dS


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


__all__ = ["wkv_bwd_ref", "wkv_bwd_staged_ref", "wkv_ref",
           "wkv_step_ref"]
