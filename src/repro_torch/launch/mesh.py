"""Mesh shapes (port of ``repro.launch.mesh``).

The reference builds ``jax.sharding.Mesh`` objects over its devices. The
port's counterpart is a shape alone, :class:`MeshShape`: axis names and
sizes, ``.shape`` mapping each name to its size in the reference's
order. It touches no device, so :func:`make_production_mesh` describes
the production pod whatever the process holds, and the sharding rules
(:mod:`repro_torch.sharding.rules`) read it as they read a JAX mesh.
:class:`repro_torch.distributed.ProcessMesh` lays the ranks of a process
group over one (:func:`mesh_over` gives the reference's layout for a
number of ranks).

Axes:
  pod   — across pods: pure data parallelism (the paper's §4 hybrid:
          data parallel across nodes, partitioning within the node)
  data  — within-pod data parallel / ZeRO-1 / context parallel
  model — tensor/expert parallel
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device


@dataclass(frozen=True)
class MeshShape:
    """A device mesh's axes: ``axis_sizes[i]`` devices along
    ``axis_names[i]``."""
    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, (int(s) for s in self.axis_sizes)))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The production pod: (16, 16) over ("data", "model"), or (2, 16,
    16) over ("pod", "data", "model") with ``multi_pod``."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def host_device_count(device=None) -> int:
    """Devices of this process on ``device``'s kind (``None``: cuda):
    the CUDA count, or 1 on the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def make_host_mesh(data: int | None = None, model: int = 1, pod: int = 1,
                   *, device=None) -> MeshShape:
    """A mesh over the devices this process has (:func:`host_device_count`);
    ``data`` defaults to what ``model`` and ``pod`` leave."""
    return mesh_over(host_device_count(device), data, model, pod)


def mesh_over(n: int, data: int | None = None, model: int = 1,
              pod: int = 1) -> MeshShape:
    """The reference's host mesh over ``n`` devices (or ranks): (data,
    model), or (pod, data, model) with ``pod`` > 1; ``data`` defaults to
    what ``model`` and ``pod`` leave."""
    if data is None:
        data = n // (model * pod)
    if pod * data * model > n or min(pod, data, model) < 1:
        raise ValueError(f"mesh pod={pod} x data={data} x model={model} "
                         f"does not fit {n} devices")
    if pod > 1:
        return MeshShape((pod, data, model), ("pod", "data", "model"))
    return MeshShape((data, model), ("data", "model"))


def mesh_num_chips(mesh) -> int:
    """Devices in ``mesh`` (anything with a ``.shape`` mapping)."""
    return int(np.prod(list(mesh.shape.values())))


__all__ = ["MeshShape", "host_device_count", "make_host_mesh",
           "make_production_mesh", "mesh_num_chips", "mesh_over"]
