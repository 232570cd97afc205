"""Carry parameter trees between the JAX reference and the port as numpy.

The reference's parameters are nested dicts (and lists, for the
prelude) of arrays; :func:`params_from_numpy` turns the same tree, given
as numpy arrays, into the port's nested dicts of tensors with the same
keys and shapes — including the stacked ``params["periods"]`` layout
with its leading ``num_periods`` axis — and :func:`params_to_numpy`
turns it back. The round trip is bit-exact.

bfloat16 has no numpy dtype of its own: a bf16 leaf crosses as its raw
16-bit pattern. Turning a bf16 tensor back into numpy needs the
``bfloat16`` numpy dtype to be registered in the process (the reference
registers it when it is imported).
"""
from __future__ import annotations

import numpy as np
import torch

from .tree import tree_map


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")      # a writable copy: tensors own their data
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError:
            raise TypeError(
                "a bfloat16 tensor needs the numpy bfloat16 dtype "
                "(ml_dtypes) registered to cross to numpy") from None
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def params_from_numpy(tree, device) -> dict:
    """Reference parameter tree (numpy leaves) → port tensors on
    ``device``."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def params_to_numpy(tree) -> dict:
    """Port tensors → numpy leaves, same keys and layout."""
    return tree_map(_leaf_to_numpy, tree)


__all__ = ["params_from_numpy", "params_to_numpy"]
