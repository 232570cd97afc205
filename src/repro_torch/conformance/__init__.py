"""The training main path of the port: the train step (autograd + SGD)
driven through trace → partition → verify → execute → save/load, per
registered arch, and the serving scenario through ``plan.serve`` (the
port's side of ``repro.conformance``), and the helpers that run them in
a child process (:mod:`.subproc`)."""
from .matrix import (ArchSpec, JSON_MARK, MATRIX_OVERRIDES, build_matrix,
                     example_batch, make_train_step, matrix_archs,
                     reduced_config, run_conformance,
                     run_serving_conformance, spec_for)
from .subproc import (SubprocessError, child_env, run_arch_subprocess,
                      run_json, run_py)

__all__ = ["ArchSpec", "JSON_MARK", "MATRIX_OVERRIDES", "SubprocessError",
           "build_matrix", "child_env", "example_batch", "make_train_step",
           "matrix_archs", "reduced_config", "run_arch_subprocess",
           "run_conformance", "run_json", "run_py",
           "run_serving_conformance", "spec_for"]
