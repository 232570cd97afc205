"""CalibrationProfile: the durable, shareable calibration artifact (port
of ``repro.profiling.artifact``, the same format in both packages).

Mirrors the plan artifact's persistence format: a JSON header (schema
version, device fingerprint, fitted parameters, payload sha256,
metadata) plus a sibling ``.npz`` holding every measured sample bit for
bit. The format string and schema version are the reference's, so a
profile saved by either package loads in the other. A profile loaded on
other hardware than it was measured on is a silent-wrongness hazard:
the header carries a *device fingerprint* that
:meth:`CalibrationProfile.load` can enforce. The port's is
``cuda|<torch.cuda.get_device_name()>|x<device count>|torch=<version>``
(``cpu|cpu|x1|torch=<version>`` without a card); the reference's names
the jax backend, so a profile never passes the other package's device
check.

Header schema (version 1)::

    {
      "format": "repro-calibration-profile",
      "schema_version": 1,
      "device_fingerprint": "cuda|NVIDIA H100 80GB HBM3|x1|torch=2.5.1",
      "base_model": {.. DeviceModel params ..},
      "fitted": {"flop_efficiency": .., "hbm_bw": ..,
                 "link_bw": .., "link_latency": ..},
      "num_op_signatures": N, "num_transfer_points": M,
      "samples_file": "<stem>.npz", "samples_sha256": "...",
      "meta": {...}
    }

The npz payload: per-signature arrays (``op_sig`` .. ``op_samples`` +
``op_samples_indptr`` for the ragged raw samples) and the transfer
ladder (``tr_bytes`` / ``tr_seconds`` / ``tr_dispersion`` /
``tr_samples`` + indptr).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.costmodel import CalibratedDeviceModel, DeviceModel
from ..core.errors import (RP101_SCHEMA_UNKNOWN, RP103_PAYLOAD_CORRUPT,
                           RP104_DEVICE_MISMATCH, ProfileValidationError)
from .opbench import (CORRECTION_FLOOR_FRAC, OpSample, TransferSample,
                      corrected_seconds)

CALIB_FORMAT = "repro-calibration-profile"
CALIB_SCHEMA_VERSION = 1
KNOWN_CALIB_SCHEMA_VERSIONS = (1,)


def current_device_fingerprint() -> str:
    """Fingerprint of the measuring environment: platform, device name,
    device count, torch version; enough to refuse a profile measured on
    different hardware."""
    if torch.cuda.is_available():
        return (f"cuda|{torch.cuda.get_device_name()}"
                f"|x{torch.cuda.device_count()}|torch={torch.__version__}")
    return f"cpu|cpu|x1|torch={torch.__version__}"


def _ragged(chunks: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    indptr = np.zeros(len(chunks) + 1, dtype=np.int64)
    if chunks:
        np.cumsum([c.size for c in chunks], out=indptr[1:])
    flat = (np.concatenate(chunks) if chunks
            else np.zeros(0)).astype(np.float64)
    return flat, indptr


def _unragged(flat: np.ndarray, indptr: np.ndarray) -> list[np.ndarray]:
    return [flat[indptr[i]:indptr[i + 1]] for i in range(indptr.size - 1)]


def _npz_path(path: str) -> str:
    stem, ext = os.path.splitext(path)
    return (stem if ext.lower() in (".json", ".profile") else path) + ".npz"


@dataclass
class CalibrationProfile:
    """Measured op/transfer samples + the device-model fit over them."""
    ops: list[OpSample]
    transfers: list[TransferSample]
    fitted: dict                      # flop_efficiency/hbm_bw/link_bw/latency
    base_model: dict                  # DeviceModel params the fit overlays
    device_fingerprint: str
    # per-call eager dispatch overhead (seconds) measured alongside the
    # ops; a segment replayed as a CUDA graph does not pay it, so
    # consumers predicting segment times subtract it
    # (op_seconds_by_signature does)
    dispatch_overhead_s: float = 0.0
    # the seconds of one replay of the whole program as one segment
    # (one CUDA graph on the card) divided by the sum of the
    # dispatch-corrected per-op costs. Annotation rescales by it; it is
    # measured independently of any partition, so scoring a plan against
    # it is not circular. The reference's jit fuses ops, which a CUDA
    # graph does not: here it records what the replay achieves against
    # the summed per-op costs. 1.0 when not measured.
    fusion_factor: float = 1.0
    meta: dict = field(default_factory=dict)
    schema_version: int = CALIB_SCHEMA_VERSION

    # -- views --------------------------------------------------------------
    def op_seconds_by_signature(self, corrected: bool = True,
                                floor_frac: float = CORRECTION_FLOOR_FRAC
                                ) -> dict[str, float]:
        """signature -> robust measured seconds (the annotation table).

        With ``corrected=True`` (default) the measured dispatch
        overhead is subtracted — the estimate of the op's cost *inside
        a compiled segment* — floored at ``floor_frac`` of the raw
        measurement so relative op ordering survives the correction
        (the same ``corrected_seconds`` the fitting path uses).
        """
        oh = self.dispatch_overhead_s if corrected else 0.0
        return {s.signature: corrected_seconds(s.seconds, oh, floor_frac)
                for s in self.ops}

    def device_model(self, base: DeviceModel | None = None
                     ) -> CalibratedDeviceModel:
        """The fitted model, overlaid on ``base`` (default: the base
        model recorded in the profile)."""
        if base is None:
            base = DeviceModel(**self.base_model)
        return CalibratedDeviceModel.from_base(
            base, source=self.device_fingerprint, **self.fitted)

    def summary(self) -> str:
        f = self.fitted
        parts = [f"{len(self.ops)} op signatures",
                 f"{len(self.transfers)} transfer points"]
        if f.get("flop_efficiency") is not None:
            parts.append(f"eff={f['flop_efficiency']:.3g}")
        if f.get("hbm_bw") is not None:
            parts.append(f"hbm={f['hbm_bw'] / 1e9:.3g}GB/s")
        if f.get("link_bw") is not None:
            parts.append(f"link={f['link_bw'] / 1e9:.3g}GB/s"
                         f"+{f.get('link_latency', 0) * 1e6:.1f}us")
        return ("CalibrationProfile[" + self.device_fingerprint + "]: "
                + ", ".join(parts))

    # -- persistence --------------------------------------------------------
    def _arrays(self) -> dict[str, np.ndarray]:
        ops = self.ops
        op_samples, op_indptr = _ragged([s.samples for s in ops])
        tr_samples, tr_indptr = _ragged([t.samples for t in self.transfers])
        return {
            "op_sig": np.asarray([s.signature for s in ops]),
            "op_name": np.asarray([s.name for s in ops]),
            "op_flops": np.asarray([s.flops for s in ops], np.float64),
            "op_bytes": np.asarray([s.bytes_touched for s in ops],
                                   np.float64),
            "op_out_bytes": np.asarray([s.out_bytes for s in ops],
                                       np.float64),
            "op_seconds": np.asarray([s.seconds for s in ops], np.float64),
            "op_dispersion": np.asarray([s.dispersion for s in ops],
                                        np.float64),
            "op_count": np.asarray([s.count for s in ops], np.int64),
            "op_samples": op_samples, "op_samples_indptr": op_indptr,
            "tr_bytes": np.asarray([t.nbytes for t in self.transfers],
                                   np.float64),
            "tr_seconds": np.asarray([t.seconds for t in self.transfers],
                                     np.float64),
            "tr_dispersion": np.asarray(
                [t.dispersion for t in self.transfers], np.float64),
            "tr_samples": tr_samples, "tr_samples_indptr": tr_indptr,
        }

    def save(self, path: str) -> str:
        """Write ``path`` (JSON header) + sibling ``.npz``; returns path."""
        apath = _npz_path(path)
        arrays = self._arrays()
        with open(apath, "wb") as f:
            np.savez(f, **arrays)
        with open(apath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        header = {
            "format": CALIB_FORMAT,
            "schema_version": self.schema_version,
            "device_fingerprint": self.device_fingerprint,
            "dispatch_overhead_s": float(self.dispatch_overhead_s),
            "fusion_factor": float(self.fusion_factor),
            "base_model": self.base_model,
            "fitted": {k: (None if v is None else float(v))
                       for k, v in self.fitted.items()},
            "num_op_signatures": len(self.ops),
            "num_transfer_points": len(self.transfers),
            "samples_file": os.path.basename(apath),
            "samples_sha256": digest,
            "meta": self.meta,
        }
        with open(path, "w") as f:
            json.dump(header, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str, *, expect_device: str | bool = False
             ) -> "CalibrationProfile":
        """Load and validate a profile artifact.

        Raises :class:`ProfileValidationError` on a wrong format, an
        unknown schema version, a corrupted samples payload, or — with
        ``expect_device=True`` (check against this process's devices)
        or an explicit fingerprint string — a device mismatch.
        """
        with open(path) as f:
            header = json.load(f)
        if header.get("format") != CALIB_FORMAT:
            raise ProfileValidationError(
                f"{path}: not a {CALIB_FORMAT} file "
                f"(format={header.get('format')!r})")
        ver = header.get("schema_version")
        if ver not in KNOWN_CALIB_SCHEMA_VERSIONS:
            raise ProfileValidationError(
                f"{path}: unknown calibration schema version {ver!r}; "
                f"this build supports "
                f"{list(KNOWN_CALIB_SCHEMA_VERSIONS)} — re-run "
                f"repro_torch.api.calibrate or upgrade the library",
                code=RP101_SCHEMA_UNKNOWN)
        apath = os.path.join(os.path.dirname(os.path.abspath(path)),
                             header["samples_file"])
        with open(apath, "rb") as f:
            raw = f.read()
        digest = hashlib.sha256(raw).hexdigest()
        if digest != header["samples_sha256"]:
            raise ProfileValidationError(
                f"{path}: samples payload corrupted "
                f"(sha256 {digest[:12]}… != header "
                f"{header['samples_sha256'][:12]}…)",
                code=RP103_PAYLOAD_CORRUPT)
        if expect_device:
            want = (current_device_fingerprint()
                    if expect_device is True else str(expect_device))
            got = header.get("device_fingerprint")
            if got != want:
                raise ProfileValidationError(
                    f"{path}: profile was measured on {got!r}, this "
                    f"environment is {want!r} — measured costs do not "
                    f"transfer across devices; re-run "
                    f"repro_torch.api.calibrate "
                    f"(or pass expect_device=False to override)",
                    code=RP104_DEVICE_MISMATCH)
        import io
        with np.load(io.BytesIO(raw)) as z:
            op_chunks = _unragged(z["op_samples"], z["op_samples_indptr"])
            ops = [OpSample(signature=str(z["op_sig"][i]),
                            name=str(z["op_name"][i]),
                            flops=float(z["op_flops"][i]),
                            bytes_touched=float(z["op_bytes"][i]),
                            out_bytes=float(z["op_out_bytes"][i]),
                            seconds=float(z["op_seconds"][i]),
                            dispersion=float(z["op_dispersion"][i]),
                            count=int(z["op_count"][i]),
                            samples=op_chunks[i])
                   for i in range(z["op_sig"].shape[0])]
            tr_chunks = _unragged(z["tr_samples"], z["tr_samples_indptr"])
            transfers = [TransferSample(nbytes=float(z["tr_bytes"][i]),
                                        seconds=float(z["tr_seconds"][i]),
                                        dispersion=float(
                                            z["tr_dispersion"][i]),
                                        samples=tr_chunks[i])
                         for i in range(z["tr_bytes"].shape[0])]
        return cls(ops=ops, transfers=transfers,
                   fitted=dict(header["fitted"]),
                   base_model=dict(header["base_model"]),
                   device_fingerprint=header["device_fingerprint"],
                   dispatch_overhead_s=float(
                       header.get("dispatch_overhead_s", 0.0)),
                   fusion_factor=float(header.get("fusion_factor", 1.0)),
                   meta=dict(header.get("meta") or {}),
                   schema_version=int(ver))


def profile_differences(a, b) -> list[str]:
    """Where two calibration profiles differ: ``[]`` when they are equal
    field for field and their arrays bit for bit. Walks the dataclass
    fields of both, into the op and transfer samples, so a profile of the
    reference package's class compares too, and a field added to the
    format is compared without being named here."""
    return _differences(a, b, "profile")


def _differences(a, b, where: str) -> list[str]:
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        names = dict.fromkeys(f.name for f in (*dataclasses.fields(a),
                                               *dataclasses.fields(b)))
        out = []
        for name in names:
            if not (hasattr(a, name) and hasattr(b, name)):
                out.append(f"{where}.{name} (on one side only)")
            else:
                out += _differences(getattr(a, name), getattr(b, name),
                                    f"{where}.{name}")
        return out
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return [] if np.array_equal(a, b) else [where]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{where} (length {len(a)} against {len(b)})"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _differences(x, y, f"{where}[{i}]")]
    return [] if a == b else [where]


__all__ = ["CALIB_FORMAT", "CALIB_SCHEMA_VERSION", "CalibrationProfile",
           "KNOWN_CALIB_SCHEMA_VERSIONS", "ProfileValidationError",
           "current_device_fingerprint", "profile_differences"]
