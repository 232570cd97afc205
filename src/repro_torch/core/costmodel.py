"""Device cost model (copy of the reference's ``repro/core/costmodel.py``
with the H100 as the target).

ParDNN consumes *annotated* graphs: per-node compute seconds, output bytes
and per-edge communication seconds. The paper obtains these from TensorFlow
profiling on V100s; the framework derives them analytically from a device
model, until calibration fits the model to measurements.

NVIDIA H100 SXM (target hardware; NVIDIA's data sheet, dense rates):
  peak bf16      : 989 TFLOP/s per card
  HBM3 bandwidth : 3.35 TB/s per card
  NVLink 4       : 900 GB/s per card both ways, 450 GB/s per direction
  memory         : 80 GB
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

H100_PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
H100_HBM_BW = 3.35e12             # bytes/s per card (HBM3)
H100_NVLINK_BW = 450e9            # bytes/s per direction (bidir 900)
H100_HBM_BYTES = 80 * 2**30

# V100-SXM3-32GB — the paper's testbed (DGX-2); used by the paper-fidelity
# benchmarks so reported numbers are comparable with the paper's setting.
V100_PEAK_FLOPS = 125e12          # fp16 tensor-core FLOP/s
V100_HBM_BW = 900e9
V100_NVSWITCH_BW = 150e9          # per-GPU NVSwitch bandwidth (bidir 300)
V100_HBM_BYTES = 32 * 2**30


@dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: float          # FLOP/s
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s (interconnect, per device)
    hbm_bytes: float           # memory capacity
    link_latency: float = 1e-6 # seconds per message (alpha term)
    flop_efficiency: float = 0.5   # sustained fraction of peak for dense ops
    mem_fraction: float = 0.9      # paper §4: spare 10% for fragmentation etc.
    # parallel outgoing transfer channels per device — the width of the
    # comm FIFO the overlap emulator serializes cross-device edges on
    # (1 = the paper's single comm queue per device)
    comm_streams: int = 1

    def compute_seconds(self, flops: float, bytes_touched: float = 0.0) -> float:
        """Roofline op time: max(compute, memory) term."""
        t_c = flops / (self.peak_flops * self.flop_efficiency)
        t_m = bytes_touched / self.hbm_bw
        return max(t_c, t_m)

    def comm_seconds(self, nbytes: float) -> float:
        return self.link_latency + nbytes / self.link_bw

    def transfer_seconds(self, nbytes: float) -> float:
        """Alias of :meth:`comm_seconds` — the segment runtime's name for
        the cost of one cross-device tensor transfer (alpha + bytes/bw).
        Both the tracer's per-edge comm annotation and the runtime's
        transfer accounting go through this one model."""
        return self.comm_seconds(nbytes)

    @property
    def usable_hbm(self) -> float:
        return self.hbm_bytes * self.mem_fraction

    def to_dict(self) -> dict:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw, "link_bw": self.link_bw,
                "hbm_bytes": self.hbm_bytes,
                "link_latency": self.link_latency,
                "flop_efficiency": self.flop_efficiency,
                "mem_fraction": self.mem_fraction,
                "comm_streams": self.comm_streams}


@dataclass(frozen=True)
class CalibratedDeviceModel(DeviceModel):
    """A :class:`DeviceModel` whose sustained parameters were *fitted
    from measurements* instead of guessed (calibration; not ported yet).

    Same pricing interface — everything that consumes a DeviceModel
    (tracer, emulator, runtime transfer accounting) works unchanged;
    ``source`` records the CalibrationProfile's device fingerprint so a
    plan's costs are traceable to the measurement run behind them.
    """
    source: str = ""                 # calibration device fingerprint

    @classmethod
    def from_base(cls, base: DeviceModel, *, source: str = "",
                  **fitted) -> "CalibratedDeviceModel":
        d = base.to_dict()
        d.update({k: v for k, v in fitted.items() if v is not None})
        if not d["name"].endswith("+calibrated"):
            d["name"] += "+calibrated"
        return cls(source=source, **d)


H100 = DeviceModel("h100-sxm", H100_PEAK_FLOPS, H100_HBM_BW,
                   H100_NVLINK_BW, H100_HBM_BYTES)
V100 = DeviceModel("v100-sxm3", V100_PEAK_FLOPS, V100_HBM_BW,
                   V100_NVSWITCH_BW, V100_HBM_BYTES)


def dtype_bytes(dtype) -> int:
    return np.dtype(dtype).itemsize
