"""Lint a saved plan artifact from the command line (the port's side of
``python -m repro.analysis``).

    python -m repro_torch.analysis \\
        results/dryrun_torch/arch__pardnn_k4.plan.json
    python -m repro_torch.analysis plan.json --arch repro-lm-100m \\
        --json rep.json

Without ``--arch`` only the artifact + placement passes run (the .npz
carries no program). With ``--arch`` the reduced config's loss is
re-traced on ``--device`` (default ``cuda``) exactly as
``python -m repro_torch.launch.dryrun --pardnn`` traces it, and bound,
enabling the full schedule passes; a fingerprint mismatch is reported as
an RP033 error rather than crashing.

Exit codes: 0 clean, 1 error-severity findings, 2 artifact unloadable.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="statically verify a saved PartitionPlan artifact")
    ap.add_argument("plan", help="path to a .plan.json artifact")
    ap.add_argument("--arch", default=None,
                    help="rebuild ARCH's reduced-config trace and run the "
                         "full schedule passes (default: structural only)")
    ap.add_argument("--device", default=None,
                    help="with --arch: cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the full diagnostic report as JSON")
    ap.add_argument("--max-findings", type=int, default=50)
    ap.add_argument("--warn-error", action="store_true",
                    help="exit 1 on warnings too")
    args = ap.parse_args(argv)

    from ..api import PartitionPlan
    from ..core.errors import PlanValidationError
    from . import analyze_plan
    try:
        plan = PartitionPlan.load(args.plan)
    except (PlanValidationError, OSError, KeyError, ValueError) as e:
        print(f"error: cannot load {args.plan}: {e}", file=sys.stderr)
        return 2
    if args.arch:
        from ..launch.dryrun import reduced_loss_trace
        # assign directly instead of bind(): a mismatched trace must
        # become an RP033 diagnostic, not an exception
        _, plan.traced = reduced_loss_trace(args.arch, args.device)
    rep = analyze_plan(plan)
    print(f"{args.plan}: {plan.summary()}")
    print(rep.render(max_findings=args.max_findings))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep.to_dict(), f, indent=1)
        print(f"wrote {args.json}")
    return 1 if rep.has_errors() or (args.warn_error and rep.warnings) \
        else 0


if __name__ == "__main__":
    sys.exit(main())
