"""Shared exception types and the structured error-code namespace.

A copy of the reference's ``repro/core/errors.py``: the codes are the
same in both packages, so a plan refused by one is refused by the other
with the same code. ``PlanValidationError`` lives here (not in
``repro_torch.api``) so that the execution layer can raise it on
malformed placements without importing the facade; ``repro_torch.api``
re-exports it.

Every failure mode carries a stable ``RPxxx`` code, so exception
messages and lint findings are greppable under one namespace:

* ``RP0xx`` — static-analysis diagnostics (schedule safety, memory
  certificates, lints), emitted by the plan verifier
  (``repro_torch.analysis``); error-severity diagnostics escalate to
  :class:`PlanValidationError` with the same code.
* ``RP1xx`` — artifact/plan validation failures raised directly as
  exceptions (schema drift, payload corruption, unrealizable
  placements).

Exception messages are prefixed ``[RPxxx]`` so a grep for a code finds
both the raise site and any logged occurrence.
"""
from __future__ import annotations

# --- RP0xx: static-analysis diagnostic codes (plan verifier) ---------------
RP001_USE_AFTER_FREE = "RP001"
RP002_DOUBLE_FREE = "RP002"
RP003_BAD_DONATION = "RP003"
RP004_LEAKED_BUFFER = "RP004"
RP010_ORDER_VIOLATION = "RP010"
RP011_DEPENDENCY_CYCLE = "RP011"
RP012_MISSING_TRANSFER = "RP012"
RP013_UNDEFINED_VALUE = "RP013"
RP014_NODE_NOT_SCHEDULED = "RP014"
RP015_NODE_SCHEDULED_TWICE = "RP015"
RP020_MEMORY_CAP_OVERFLOW = "RP020"
RP021_PEAK_PREDICTION_DRIFT = "RP021"
RP030_REDUNDANT_TRANSFER = "RP030"
RP031_DEAD_NODE = "RP031"
RP032_PLACEMENT_HOLE = "RP032"
RP033_FINGERPRINT_DRIFT = "RP033"
RP034_REFCOUNT_TABLE_DRIFT = "RP034"
RP040_TRANSFER_WINDOW_EXCEEDED = "RP040"
RP041_DISPATCH_DEADLOCK = "RP041"
RP042_OVERLAP_DONATION_HAZARD = "RP042"

# --- RP1xx: artifact/plan validation exception codes ----------------------
RP100_PLAN_INVALID = "RP100"
RP101_SCHEMA_UNKNOWN = "RP101"
RP102_FINGERPRINT_MISMATCH = "RP102"
RP103_PAYLOAD_CORRUPT = "RP103"
RP104_DEVICE_MISMATCH = "RP104"
RP105_PROFILE_INVALID = "RP105"
RP106_PLAN_NOT_EXECUTABLE = "RP106"
RP107_VERIFICATION_FAILED = "RP107"

#: code -> one-line description; the single registry both the exception
#: layer and the analysis diagnostics draw from.
CODES: dict[str, str] = {
    RP001_USE_AFTER_FREE: "use-after-free: a segment reads a buffer the "
                          "refcount schedule already freed",
    RP002_DOUBLE_FREE: "double-free: a producer's refcount is decremented "
                       "below zero",
    RP003_BAD_DONATION: "bad donation: a donated buffer is read later, "
                        "donated twice, or is a resident/program output",
    RP004_LEAKED_BUFFER: "leaked buffer: a value stays live after its last "
                         "reader (refcount never reaches zero)",
    RP010_ORDER_VIOLATION: "schedule-order violation: a segment consumes a "
                           "value produced by a later segment (deadlock "
                           "under in-order dispatch)",
    RP011_DEPENDENCY_CYCLE: "dependency cycle in the segment/transfer "
                            "graph (hang under async dispatch)",
    RP012_MISSING_TRANSFER: "cross-device read without a transfer op",
    RP013_UNDEFINED_VALUE: "read of a value no segment or root produces",
    RP014_NODE_NOT_SCHEDULED: "program node missing from every segment",
    RP015_NODE_SCHEDULED_TWICE: "program node scheduled in more than one "
                                "segment",
    RP020_MEMORY_CAP_OVERFLOW: "static peak-memory certificate exceeds the "
                               "per-device capacity the plan claims to fit",
    RP021_PEAK_PREDICTION_DRIFT: "static peak certificate diverges from "
                                 "Step-2's predicted peak beyond the "
                                 "documented tolerance",
    RP030_REDUNDANT_TRANSFER: "redundant transfer: the same value is "
                              "shipped to the same device twice",
    RP031_DEAD_NODE: "dead node: outputs never consumed and not a program "
                     "output",
    RP032_PLACEMENT_HOLE: "placement hole: node unplaced or assigned "
                          "outside [0, K)",
    RP033_FINGERPRINT_DRIFT: "plan fingerprint/schema does not match the "
                             "bound trace",
    RP034_REFCOUNT_TABLE_DRIFT: "schedule refcount table disagrees with "
                                "the recomputed segment-level liveness",
    RP040_TRANSFER_WINDOW_EXCEEDED: "async prefetch liveness bound breaks "
                                    "the in-flight transfer window, or the "
                                    "async-timing peak certificate exceeds "
                                    "a device cap the plan claims to fit",
    RP041_DISPATCH_DEADLOCK: "async dispatch-order deadlock: the prefetch "
                             "schedule references a slot its producer has "
                             "not dispatched, or the dispatch/transfer "
                             "wait graph has a cycle",
    RP042_OVERLAP_DONATION_HAZARD: "donation unsafe under overlap: a "
                                   "prefetched transfer reads a buffer "
                                   "after a segment donated it",
    RP100_PLAN_INVALID: "plan artifact failed validation",
    RP101_SCHEMA_UNKNOWN: "unknown plan/profile schema version",
    RP102_FINGERPRINT_MISMATCH: "graph fingerprint mismatch",
    RP103_PAYLOAD_CORRUPT: "artifact payload corrupted",
    RP104_DEVICE_MISMATCH: "placement cannot be realized on the given "
                           "devices",
    RP105_PROFILE_INVALID: "calibration-profile artifact failed validation",
    RP106_PLAN_NOT_EXECUTABLE: "plan has no executable program bound",
    RP107_VERIFICATION_FAILED: "static plan verification found "
                               "error-severity diagnostics",
}


class PlanValidationError(ValueError):
    """A plan artifact failed schema/fingerprint/integrity validation,
    or a placement cannot be realized on the given devices.

    Carries a stable ``code`` from :data:`CODES` (default ``RP100``);
    ``str()`` is prefixed ``[RPxxx]`` so logs and messages are greppable
    under the shared namespace.
    """

    default_code = RP100_PLAN_INVALID

    def __init__(self, message: str, *, code: str | None = None):
        self.code = code or self.default_code
        super().__init__(f"[{self.code}] {message}")


class ProfileValidationError(PlanValidationError):
    """A calibration-profile artifact failed schema/payload validation,
    or was measured on a different device than it is being applied to
    (:class:`repro_torch.profiling.CalibrationProfile`). Subclasses
    PlanValidationError so one except-clause guards both artifact
    kinds."""

    default_code = RP105_PROFILE_INVALID
