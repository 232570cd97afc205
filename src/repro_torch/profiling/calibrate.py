"""Fit :class:`DeviceModel` parameters from profiled measurements (port
of ``repro.profiling.calibrate``).

The analytic cost model prices every op with three guessed constants —
sustained ``flop_efficiency``, effective HBM bandwidth, and an
alpha–beta link model. This module replaces the guesses with fits:

* **alpha–beta transfer model** — least-squares regression of measured
  copy seconds (:func:`.opbench.profile_transfers`) over payload size: ``t(b) = alpha + b / bw``.
  Slope → effective link bandwidth, intercept → per-message latency.
* **flop efficiency** — for compute-bound signatures (arithmetic
  intensity above the device's roofline ridge point), sustained FLOP/s
  is ``flops / seconds``; the FLOPs-weighted median over signatures,
  divided by peak, is the sustained fraction.
* **effective HBM bandwidth** — for memory-bound signatures, achieved
  bytes/s is ``bytes_touched / seconds``; again a weighted median.

Fits are deliberately *robust over clever*: medians over per-signature
point estimates, not a global regression — a single miss-timed op
(a shared host's timing is bimodal under load) must not drag the
model. Signatures whose measurement stayed noisy after the estimator's
retries (``dispersion > NOISY_CUTOFF``) are excluded from fitting but
kept in the profile for inspection.
"""
from __future__ import annotations

import numpy as np

from ..core.costmodel import H100, CalibratedDeviceModel, DeviceModel
from .opbench import OpSample, TransferSample, corrected_seconds

#: Per-signature dispersion above which a sample is excluded from fits.
NOISY_CUTOFF = 0.5

#: Ignore ops faster than this when fitting — sub-ulp timings are clock
#: noise, not device behaviour.
MIN_FIT_SECONDS = 2e-6


def fit_alpha_beta(sizes, seconds) -> tuple[float, float]:
    """Least-squares fit ``t = alpha + beta * bytes``.

    Returns ``(alpha, bw)`` with ``bw = 1/beta``; alpha is clamped to
    >= 0 and beta to > 0 (a negative slope means the samples were pure
    noise — fall back to the steepest single-point bound).
    """
    b = np.asarray(sizes, dtype=np.float64)
    t = np.asarray(seconds, dtype=np.float64)
    if b.size == 0:
        raise ValueError("no transfer samples to fit")
    if b.size == 1:
        return 0.0, float(b[0] / max(t[0], 1e-12))
    A = np.stack([np.ones_like(b), b], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, t, rcond=None)
    if beta <= 0:
        # noise-dominated: bandwidth from the largest payload alone
        # (latency amortized), latency from the smallest
        i, j = int(np.argmax(b)), int(np.argmin(b))
        return max(float(t[j]), 0.0), float(b[i] / max(t[i], 1e-12))
    return max(float(alpha), 0.0), float(1.0 / beta)


def _weighted_median(values: np.ndarray, weights: np.ndarray) -> float:
    order = np.argsort(values)
    v, w = values[order], weights[order]
    cw = np.cumsum(w)
    return float(v[int(np.searchsorted(cw, 0.5 * cw[-1]))])


def fit_compute_params(ops: list[OpSample], base: DeviceModel,
                       dispatch_overhead_s: float = 0.0
                       ) -> tuple[float | None, float | None]:
    """(flop_efficiency, hbm_bw) fits from measured op signatures.

    Signatures are split at the base model's roofline ridge point
    (peak/bw FLOP per byte): above it, sustained FLOP/s calibrates the
    efficiency; below it, achieved bytes/s calibrates the bandwidth.
    ``dispatch_overhead_s`` (the measured per-bind cost; see
    ``opbench.measure_dispatch_overhead``) is subtracted from every
    sample first: the fitted parameters describe the *device*, not the
    eager dispatch path. Returns None for a side with no usable samples.
    """
    ridge = base.peak_flops / max(base.hbm_bw, 1.0)
    eff_v, eff_w, bw_v, bw_w = [], [], [], []
    for s in ops:
        secs = corrected_seconds(s.seconds, dispatch_overhead_s)
        if secs < MIN_FIT_SECONDS or s.dispersion > NOISY_CUTOFF:
            continue
        if s.flops > 0 and s.bytes_touched > 0 \
                and s.flops / s.bytes_touched >= ridge:
            eff_v.append(s.flops / secs / base.peak_flops)
            eff_w.append(s.flops * s.count)
        elif s.bytes_touched > 0:
            bw_v.append(s.bytes_touched / secs)
            bw_w.append(s.bytes_touched * s.count)
    eff = None
    if eff_v:
        eff = _weighted_median(np.asarray(eff_v), np.asarray(eff_w))
        eff = float(np.clip(eff, 1e-6, 1.0))
    bw = None
    if bw_v:
        bw = float(max(_weighted_median(np.asarray(bw_v),
                                        np.asarray(bw_w)), 1.0))
    return eff, bw


def fit_params(ops: list[OpSample], transfers: list[TransferSample],
               base: DeviceModel = H100, *,
               dispatch_overhead_s: float = 0.0) -> dict:
    """All raw fits as a dict, with **None for every side that had no
    usable measurements** — the distinction the artifact preserves so a
    partial calibration never masquerades the base model's guesses as
    measured values."""
    eff, hbm_bw = fit_compute_params(ops, base, dispatch_overhead_s)
    alpha = link_bw = None
    usable = [t for t in transfers if t.dispersion <= NOISY_CUTOFF]
    if usable:
        alpha, link_bw = fit_alpha_beta([t.nbytes for t in usable],
                                        [t.seconds for t in usable])
    return {"flop_efficiency": eff, "hbm_bw": hbm_bw,
            "link_bw": link_bw, "link_latency": alpha}


def fit_device_model(ops: list[OpSample],
                     transfers: list[TransferSample],
                     base: DeviceModel = H100, *,
                     dispatch_overhead_s: float = 0.0,
                     source: str = "") -> CalibratedDeviceModel:
    """Fold all fits into a :class:`CalibratedDeviceModel` over ``base``.

    Sides with no usable measurements keep the base model's value — a
    calibration can legitimately cover only ops or only transfers.
    """
    return CalibratedDeviceModel.from_base(
        base, source=source,
        **fit_params(ops, transfers, base,
                     dispatch_overhead_s=dispatch_overhead_s))


__all__ = ["MIN_FIT_SECONDS", "NOISY_CUTOFF", "fit_alpha_beta",
           "fit_compute_params", "fit_device_model", "fit_params"]
