"""PyTorch/CUDA port of the ``repro`` serving path.

A second package beside ``repro`` (the JAX reference, left unchanged).
It imports ``torch``, ``numpy`` and the standard library only, never
``jax`` or ``repro``; weights cross between the two through
:mod:`repro_torch.bridge` as numpy arrays.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the tests do); asking for ``cuda`` on a machine without one raises.

TF32 is off for the whole port: the float32 tolerances the tests hold the
port to (2e-5 kernel, 1e-4 model) need full-precision float32 products,
and PyTorch lets cuDNN use TF32 by default.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Raises when CUDA is asked for and there is none: the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            f"false; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
