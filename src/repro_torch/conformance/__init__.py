"""The training main path of the port: the train step (autograd + SGD)
driven through trace → partition → verify → execute → save/load, per
registered arch (the port's side of ``repro.conformance``)."""
from .matrix import (ArchSpec, JSON_MARK, MATRIX_OVERRIDES, build_matrix,
                     example_batch, make_train_step, reduced_config,
                     run_conformance, spec_for)

__all__ = ["ArchSpec", "JSON_MARK", "MATRIX_OVERRIDES", "build_matrix",
           "example_batch", "make_train_step", "reduced_config",
           "run_conformance", "spec_for"]
