"""CLI for the static communication verifier and schedule compiler.

    python -m mpi4jax_tpu_torch.analyze program.py --np 4 [--json]
                                   [--timeout S] [--schedules]
                                   [--show-output] [--symbolic auto|off]
                                   [--errors-only] [--optimize]
                                   [--emit-plan OUT.json]
                                   [--diff-plan GOLDEN.json] [-- ARGS]
    python -m mpi4jax_tpu_torch.analyze -m package.module --np 4 [...]

The counterpart of ``mpi4jax_tpu/analysis/_cli.py``, with its options and
exit codes, and ``-m`` for a module program as the port's launcher has.
Runs the program once per simulated rank inside one process (virtual
world: threads, in-memory matching, real values — no processes spawned,
no live communication), and prints the findings table with the finding
kind, the rank pair, and the source line of every involved op.
``--optimize`` additionally compiles the verified schedule into an
execution plan gated by the equivalence prover; ``--json`` always reports
the schedule/plan ``cache_key`` and ``analyzer_version`` so plan caches
invalidate and CI diffs stay stable.

Exit codes: 0 clean, 3 findings reported (or plan drift under
``--diff-plan``), 2 usage or analyzer error — the same contract
``mpi4jax_tpu_torch.runtime.launch --verify`` relies on.
"""

from __future__ import annotations

import argparse
import json
import sys

EXIT_CLEAN = 0
EXIT_ERROR = 2
EXIT_FINDINGS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi4jax_tpu_torch.analyze",
        description="statically verify a world-tier program's "
                    "communication schedule (no processes, no live comm)",
    )
    ap.add_argument("-m", dest="module", action="store_true",
                    help="PROG is a module, run as each rank's program "
                         "(python -m), as the launcher's -m")
    ap.add_argument("prog", help="per-rank python program (or module "
                                 "under -m) to verify")
    ap.add_argument("-n", "--np", type=int, required=True, dest="np_",
                    metavar="N", help="world size to verify at")
    ap.add_argument("--timeout", type=float, default=None,
                    help="virtual-world wall deadline in seconds "
                         "(default MPI4JAX_TPU_ANALYZE_TIMEOUT_S or 120)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--schedules", action="store_true",
                    help="also print each rank's extracted schedule")
    ap.add_argument("--show-output", action="store_true",
                    help="echo the analyzed program's captured "
                         "stdout/stderr")
    ap.add_argument("--symbolic", choices=("auto", "off"), default=None,
                    help="rank-symbolic analysis: auto (default; the "
                         "symbolic path engages on canonicalizable "
                         "schedules at large world sizes, with sound "
                         "concrete fallback) or off (pin the concrete "
                         "path bit-for-bit).  Overrides "
                         "MPI4JAX_TPU_ANALYZE_SYMBOLIC for this run")
    ap.add_argument("--errors-only", action="store_true",
                    help="exit 3 only on error-severity findings; "
                         "warnings are still printed (the launch "
                         "--verify gate uses this: a warning documents "
                         "an assumption, it does not block a job)")
    ap.add_argument("--optimize", action="store_true",
                    help="also run the schedule compiler: dependence "
                         "analysis + verified rewrite (concurrency "
                         "groups, hoisted recv posts, coalesce/bucket "
                         "marks); prints the plan and the equivalence-"
                         "prover verdict")
    ap.add_argument("--emit-plan", metavar="OUT.json", default=None,
                    help="write the verified execution plan as JSON "
                         "(implies --optimize); the JAX package's plan "
                         "format")
    ap.add_argument("--diff-plan", metavar="GOLDEN.json", default=None,
                    help="diff the compiled plan against a golden plan "
                         "file (implies --optimize); exits 3 on drift — "
                         "the verify-corpus CI contract")
    # anything the analyzer doesn't recognize is the PROGRAM's argv
    # (its sys.argv, exactly as under the launcher); a leading "--"
    # separates explicitly when a program flag collides with ours
    args, prog_args = ap.parse_known_args(argv)
    if prog_args[:1] == ["--"]:
        prog_args = prog_args[1:]

    if args.np_ < 1:
        print("--np must be >= 1", file=sys.stderr)
        return EXIT_ERROR
    if args.symbolic is not None:
        import os

        os.environ["MPI4JAX_TPU_ANALYZE_SYMBOLIC"] = args.symbolic

    from . import check_program

    try:
        report = check_program(args.prog, args.np_,
                               timeout_s=args.timeout,
                               argv=prog_args, module=args.module)
    except (OSError, SyntaxError, ValueError) as err:
        # unreadable file / not-python / bad arguments: usage error
        print(f"cannot analyze {args.prog}: {err}", file=sys.stderr)
        return EXIT_ERROR
    except Exception as err:  # analyzer bug: still honor the contract
        import traceback

        traceback.print_exc()
        print(f"analyzer error on {args.prog}: {err}", file=sys.stderr)
        return EXIT_ERROR

    optimize = args.optimize or args.emit_plan or args.diff_plan
    plan_drift = None
    if optimize:
        from . import diff_plans, load_plan, plan_report, save_plan

        try:
            plan = plan_report(report)
        except ValueError as err:
            # e.g. a typo'd MPI4JAX_TPU_PLAN_BUCKET_KB: keep the CLI's
            # documented exit contract (2 = analyzer/usage error), not
            # a raw traceback the launch gate cannot classify
            print(f"schedule compiler error: {err}", file=sys.stderr)
            return EXIT_ERROR
        if args.emit_plan:
            save_plan(plan, args.emit_plan)
        if args.diff_plan:
            try:
                golden = load_plan(args.diff_plan)
            except (OSError, ValueError, KeyError) as err:
                print(f"cannot load golden plan {args.diff_plan}: {err}",
                      file=sys.stderr)
                return EXIT_ERROR
            plan_drift = diff_plans(golden, plan)
            if plan_drift and not args.json:
                print("PLAN DRIFT against "
                      f"{args.diff_plan}:\n{plan_drift}", file=sys.stderr)

    if args.json:
        blob = report.to_json()
        if plan_drift is not None:
            # CI consumers must be able to tell drift from findings —
            # and see WHAT drifted — from the JSON alone
            blob["plan_drift"] = plan_drift
        print(json.dumps(blob))
    else:
        print(report.format_table(show_schedules=args.schedules))
        if optimize:
            print(report.plan.format())
        if args.show_output and report.output:
            print("-- program output (captured) --")
            print(report.output, end="")
    flagged = report.errors if args.errors_only else report.findings
    if flagged:
        return EXIT_FINDINGS
    return EXIT_FINDINGS if plan_drift else EXIT_CLEAN


if __name__ == "__main__":
    sys.exit(main())
