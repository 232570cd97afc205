"""Plain PyTorch versions of the selective scan and its gradient.

:func:`selective_scan_ref` is the function of the reference's
``models.ssm._ssm_scan_chunked``, stepped one token at a time in
float32::

    h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · u_t) B_t,   y_t = Σ_n h_t C_t

It takes any S: the reference cuts S into ``S // (S // chunk)`` equal
chunks, which no S that is not a multiple of its chunk count fills
(S = 17 at chunk 8), and its chunks change only the order of the sums.
:func:`selective_scan_bwd_ref` is its gradient written out as the
reverse walk the CUDA backward takes (a custom op's CPU kernel runs
below autograd, so it cannot call ``torch.autograd.grad``)."""
from __future__ import annotations

import torch


def _f32(*ts):
    return [None if t is None else t.float() for t in ts]


def selective_scan_ref(u, dt, Bm, Cm, A, h0=None):
    """u, dt: (B, S, di); Bm, Cm: (B, S, N); A: (di, N); ``h0``: (B, di,
    N) or None (zeros). Returns (y (B, S, di), h_last (B, di, N)), both
    float32."""
    u, dt, Bm, Cm, A, h0 = _f32(u, dt, Bm, Cm, A, h0)
    B, S, di = u.shape
    h = (torch.zeros((B, di, A.shape[-1]), dtype=torch.float32,
                     device=u.device) if h0 is None else h0)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        b = (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        h = a * h + b
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h


def selective_scan_bwd_ref(u, dt, Bm, Cm, A, h0, dy, dh_last):
    """The gradient of :func:`selective_scan_ref`: the cotangents ``dy``
    (B, S, di) of y and ``dh_last`` (B, di, N) of h_last (either may be
    None: zeros) to (du, ddt (B, S, di), dBm, dCm (B, S, N), dA (di, N),
    dh0 (B, di, N)), all float32; dh0 is the gradient of a zero state
    when ``h0`` is None. With g_t the cotangent of h_t, carried back
    from g_S = dh_last::

        g_t  = dy_t C_t + a_{t+1} g_{t+1},   a_t = exp(dt_t A)
        du_t = Σ_n g_t B_t dt_t,   dB_t = Σ_d g_t dt_t u_t,
        ddt_t = Σ_n (g_t B_t u_t + g_t h_{t-1} a_t A),
        dC_t = Σ_d dy_t h_t,       dA = Σ_{b,t} g_t h_{t-1} a_t dt_t,
        dh0 = a_1 g_1 (the carry past the first token)."""
    u, dt, Bm, Cm, A, h0, dy, dh_last = _f32(u, dt, Bm, Cm, A, h0, dy,
                                             dh_last)
    B, S, di = u.shape
    N = A.shape[-1]
    zeros = torch.zeros((B, di, N), dtype=torch.float32, device=u.device)
    hs = [zeros if h0 is None else h0]
    for t in range(S):
        a = torch.exp(dt[:, t, :, None] * A)
        hs.append(a * hs[-1] + (dt[:, t] * u[:, t])[..., None]
                  * Bm[:, t, None, :])
    if dy is None:
        dy = torch.zeros_like(u)
    g_carry = zeros if dh_last is None else dh_last
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    for t in range(S - 1, -1, -1):
        a = torch.exp(dt[:, t, :, None] * A)
        g = dy[:, t, :, None] * Cm[:, t, None, :] + g_carry
        dCm[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        gB = g * Bm[:, t, None, :]
        ga = g * hs[t] * a
        du[:, t] = (gB * dt[:, t, :, None]).sum(-1)
        ddt[:, t] = (gB * u[:, t, :, None]).sum(-1) + (ga * A).sum(-1)
        dBm[:, t] = (g * (dt[:, t] * u[:, t])[..., None]).sum(1)
        dA = dA + (ga * dt[:, t, :, None]).sum(0)
        g_carry = a * g
    return du, ddt, dBm, dCm, dA, g_carry


__all__ = ["selective_scan_bwd_ref", "selective_scan_ref"]
