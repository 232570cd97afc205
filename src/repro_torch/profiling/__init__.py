"""repro_torch.profiling: measurement and calibration (port of
``repro.profiling``).

Closes the predict-execute loop: the partitioner plans against a cost
model, the runtime executes the plan; this package *measures* real ops,
segments and links on the card, fits the device model to the
measurements, and re-annotates cost graphs, so plans are built on
measured costs and plan predictions can be scored against the card
(``PartitionPlan.accuracy_report``).

Layers (each usable standalone):

* :mod:`.measure`: robust micro-timing (warmup, median-of-k, MAD
  outlier rejection, bimodality-aware retries); :func:`synchronize`
  waits for a value's card.
* :mod:`.opbench`: op / segment / transfer profilers.
* :mod:`.calibrate`: alpha-beta and roofline fits into a
  :class:`~repro_torch.core.costmodel.CalibratedDeviceModel`.
* :mod:`.artifact`: :class:`CalibrationProfile` save/load (JSON header +
  npz samples, the reference's format; schema and device-fingerprint
  validation).

The one-call entry point is :func:`run_calibration` (``repro_torch.api.
calibrate``). Like every entry point of the port it runs on ``cuda``
unless given ``device="cpu"``, and raises without a card: it never
times the CPU in place of the card.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from .. import resolve_device
from ..core.errors import ProfileValidationError
from ..tree import tree_flatten
from .artifact import (CALIB_SCHEMA_VERSION, CalibrationProfile,
                       current_device_fingerprint, profile_differences)
from .calibrate import (fit_alpha_beta, fit_compute_params,
                        fit_device_model, fit_params)
from .measure import (DEFAULT_SPEC, MeasureSpec, Measurement, measure_call,
                      median_mad, quick_spec, synchronize)
from .opbench import (CUDA_TRANSFER_SIZES, DEFAULT_TRANSFER_SIZES, OpSample,
                      TransferSample, default_transfer_sizes,
                      graph_signatures, measure_dispatch_overhead,
                      node_signature, profile_ops, profile_segments,
                      profile_transfers, transfer_pair, transfer_probe)

__all__ = [
    "MeasureSpec", "Measurement", "measure_call", "median_mad",
    "quick_spec", "synchronize", "DEFAULT_SPEC",
    "OpSample", "TransferSample", "node_signature", "graph_signatures",
    "profile_ops", "profile_segments", "profile_transfers",
    "transfer_pair", "transfer_probe",
    "measure_dispatch_overhead", "DEFAULT_TRANSFER_SIZES",
    "CUDA_TRANSFER_SIZES", "default_transfer_sizes",
    "fit_alpha_beta", "fit_compute_params", "fit_device_model",
    "fit_params",
    "CalibrationProfile", "CALIB_SCHEMA_VERSION",
    "current_device_fingerprint", "profile_differences",
    "ProfileValidationError",
    "run_calibration",
]


def run_calibration(traced, *example_args, spec=None, sizes=None,
                    device=None, max_signatures=None, meta=None,
                    save=None, **example_kwargs) -> CalibrationProfile:
    """Profile a traced model's ops and the device's copies, and fit the
    device model.

    Args:
        traced: a ``repro_torch.api.TracedModel`` recorded with
            ``record=True`` (the program is replayed op by op).
        example_args/kwargs: concrete inputs; default: the example the
            trace was taken with, which must then be concrete tensors
            (a trace on fake or meta tensors needs them passed here).
        spec: :class:`MeasureSpec` timing knobs (default: robust).
        sizes: transfer payload ladder (bytes); default
            :func:`default_transfer_sizes` of the device (4 KiB to 256
            MiB on a card, the reference's ladder on the CPU).
        device: the torch device the ops run on (``None``: ``cuda``,
            which raises on a machine without one); the inputs are moved
            there.
        max_signatures: measurement budget for op signatures.
        meta: free-form dict stored in the artifact header, beside what
            this call records: ``transfer_probe`` (what the transfer
            samples timed), ``device``, ``signatures`` (distinct in the
            program), ``signatures_measured`` and ``seconds`` (this
            call's).
        save: path; write the artifact before returning.

    Returns the :class:`CalibrationProfile`; feed it back through
    ``repro_torch.api.trace(..., calibration=profile)``,
    ``TracedModel.annotate(profile)``, or the ``REPRO_CALIBRATION``
    environment variable.
    """
    t0 = time.perf_counter()
    if traced.program is None:
        raise ValueError("run_calibration needs a trace recorded with "
                         "record=True (the program is replayed)")
    prog = traced.program
    if not example_args and not example_kwargs:
        example_args, example_kwargs = prog.in_tree_example
    flat = tree_flatten((tuple(example_args), dict(example_kwargs)))[0]
    fake = [i for i, a in enumerate(flat) if isinstance(a, torch.Tensor)
            and (isinstance(a, FakeTensor) or a.is_meta)]
    if fake:
        raise ValueError(
            f"run_calibration needs concrete example arguments, but input "
            f"leaves {fake[:8]} are fake or meta tensors (the example of a "
            f"trace taken on them): pass the tensors to measure with")
    src, dst = transfer_pair(device)
    device = src
    flat = [a.to(device) if isinstance(a, torch.Tensor) else a
            for a in flat]
    spec = spec or DEFAULT_SPEC
    ops = profile_ops(traced.graph, prog, *flat, device=device, spec=spec,
                      max_signatures=max_signatures)
    transfers = profile_transfers(sizes or None, src=src, dst=dst, spec=spec)
    overhead = measure_dispatch_overhead(device, spec).seconds
    base = traced.device_model
    if base is None:
        from ..core.costmodel import H100
        base = H100
    # raw fits, None where nothing usable was measured: the artifact
    # must never present the base model's guesses as calibrated values
    fitted = fit_params(ops, transfers, base, dispatch_overhead_s=overhead)
    sigs = graph_signatures(traced.graph)
    profile = CalibrationProfile(
        ops=ops, transfers=transfers, fitted=fitted,
        base_model=base.to_dict(),
        device_fingerprint=current_device_fingerprint(),
        dispatch_overhead_s=overhead,
        meta={**(meta or {}), "transfer_probe": transfer_probe(src, dst),
              "device": str(device),
              "signatures": len({sigs[nid] for nid in prog.program}),
              "signatures_measured": len(ops)})
    profile.fusion_factor = _fit_fusion_factor(traced, profile, flat,
                                               device, spec)
    profile.meta["seconds"] = time.perf_counter() - t0
    if save:
        profile.save(save)
    return profile


def _fit_fusion_factor(traced, profile, flat_args, device, spec) -> float:
    """Seconds of one replay of the whole program as one segment / the
    summed per-op costs.

    The whole program runs through ``CompiledRuntime(prog, None,
    [device])``, every input leaf read in place: on the card one CUDA
    graph, which removes the per-op launch and synchronise but fuses
    nothing. Its seconds are those of the runtime's per-segment
    profiling mode (timing events around the replay, the clock every
    plan stage is scored with; output clones not included), the median
    of ``max(spec.reps, 3)`` calls. The sum is of the dispatch-corrected
    per-op measurements (the calibrated roofline for signatures outside
    the measurement budget). Independent of any partition, so plan
    scoring against it is not circular. Clamped to [1e-3, 2], as the
    reference's.
    """
    from ..core.runtime import CompiledRuntime

    model = profile.device_model()
    corrected = profile.op_seconds_by_signature()
    g = traced.graph
    sigs = graph_signatures(g)
    pred_sum = 0.0
    for nid in traced.program.program:
        t = corrected.get(sigs[nid])
        if t is None:
            t = model.compute_seconds(float(g.op_flops[nid]),
                                      float(g.op_bytes[nid]))
        pred_sum += t
    if pred_sum <= 0:
        return 1.0
    rt = CompiledRuntime(traced.program, None, [device],
                         static_argnums=tuple(range(len(flat_args))))
    prof = profile_segments(rt, *flat_args, reps=max(spec.reps, 3))
    measured = float(np.sum(prof["seconds"]))
    return float(min(max(measured / pred_sum, 1e-3), 2.0))
