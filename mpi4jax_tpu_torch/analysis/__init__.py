"""Static communication verifier for world-tier programs.

The counterpart of ``mpi4jax_tpu/analysis/``.  Every communication
schedule the world tier runs is visible before a rank is launched: ops
carry explicit peers, roots, tags, dtypes, shapes and comms, and each rank
issues them in program order.  So mismatched collectives, unpaired sends
and receives, deadlocks and token-chain hazards are caught here, instead
of surfacing as runtime hangs that the transport's deadline turns into
late, expensive timeouts.

Three entry points:

- :func:`check` — verify a *function*: run once per simulated rank in a
  virtual session (threads, real values built from the arguments, no live
  comm, no processes), each rank's schedule and true data dependence
  recorded, then an N-rank match simulation reports deadlocks, unmatched
  or mismatched endpoints, divergent collectives and token-discipline
  violations;
- :func:`check_program` — verify a whole per-rank *program file* (or a
  module, ``module=True``) in a virtual world: one thread per rank, world
  ops served by an in-memory matcher with real values (assertions in the
  program run for real), still with no processes and no live
  communication;
- the CLI — ``python -m mpi4jax_tpu_torch.analyze prog.py --np 4`` (or
  ``-m package.module``) — and the launcher's pre-flight
  (``python -m mpi4jax_tpu_torch.runtime.launch --verify``).

The event vocabulary, ``cache_key``, the report JSON and the plan files
are the JAX package's: the same communication, run from a torch program,
gives the same key and plan.  Not here: plan *execution*
(``runtime/planrt.py``, ``launch --plan``, ``MPI4JAX_TPU_PLAN``); the
JAX analyzer's ``control_divergence`` and ``comm_in_while`` (torch has
no staged control flow: the branch taken and the real trip count are
what runs, so neither fires); ``torch.vmap`` over world ops (the ops have
no vmap rule).  See ROADMAP.md.
"""

from __future__ import annotations

import inspect

from ._events import (  # noqa: F401
    ANALYZER_VERSION,
    CommEvent,
    FINDING_KINDS,
    Finding,
    Report,
    schedule_cache_key,
)
from ._fake import AbstractComm, AnalysisError  # noqa: F401
from ._match import match_schedules  # noqa: F401
from ._plan import (  # noqa: F401
    ExecutionPlan,
    cached_plan,
    compile_schedules,
    diff_plans,
    load_bundle,
    load_plan,
    load_plan_for_size,
    save_bundle,
    save_plan,
)
from ._schedule import trace_rank_schedules  # noqa: F401
from ._sim import SimAbort, VirtualWorld  # noqa: F401
from ._symbolic import (  # noqa: F401
    SYMBOLIC_MIN_NP,
    FallbackNeeded,
    SymmetryPartition,
    Uncanonicalizable,
    match_schedules_symbolic,
    partition_schedules,
    symbolic_mode,
    verify_schedules,
)

#: what a run's own findings contribute to ``check``'s report; the
#: schedule-level verdict comes from the match simulation, as in the JAX
#: package
_RUN_KINDS = frozenset({"token_violation", "rank_error", "analysis_timeout"})


def _canonical_finding_key(f):
    """Total content order over findings: severity, kind, ranks, comm,
    message, sites.  Fully content-determined, so the final report
    order is independent of the *discovery* order — the property that
    lets the symbolic (rank-symmetry) path reproduce concrete reports
    byte-for-byte, and keeps big-np ``analyze --json`` output stable
    across analyzer-internal reorderings."""
    return (0 if f.severity == "error" else 1, f.kind,
            tuple(f.ranks), str(f.comm), f.message, tuple(f.sites))


def _dedupe(findings):
    out, seen = [], set()
    for f in findings:
        key = (f.kind, f.ranks, f.comm, f.message, f.sites)
        if key in seen:
            continue
        seen.add(key)
        out.append(f)
    out.sort(key=_canonical_finding_key)
    return out


def check(fn, *args, world_size: int = 2, **kwargs) -> Report:
    """Statically verify the communication schedule of ``fn``.

    ``fn`` runs once per simulated rank, each on its own copy of ``args``
    (tensors cloned, on their own device), in a virtual session — no
    communication happens and no processes are spawned.  Inside ``fn``,
    :func:`mpi4jax_tpu_torch.get_default_comm` returns the simulated
    rank's communicator; alternatively declare a ``comm`` parameter and
    the analyzer passes it explicitly.

    Returns a :class:`Report`; ``report.ok`` is True when no finding
    survived, and ``report.findings`` lists deadlocks, mismatches,
    divergent collectives and token-discipline hazards otherwise.
    ``report.value_deps`` holds each rank's true data dependence pairs,
    ``report.results`` each rank's return value of ``fn``.
    """
    takes_comm = False
    try:
        takes_comm = "comm" in inspect.signature(fn).parameters \
            and "comm" not in kwargs
    except (TypeError, ValueError):
        pass
    world = trace_rank_schedules(fn, args, kwargs, world_size, takes_comm)
    schedules = world.schedules
    comms = {(0,): tuple(range(world_size))}
    symmetry = None
    if world.aborted:
        # the ranks stopped where the matcher proved the fault: its
        # verdict is the report (the schedules end there)
        findings = list(world.findings)
    else:
        match_findings, symmetry = verify_schedules(schedules, comms)
        findings = [f for f in world.findings if f.kind in _RUN_KINDS] \
            + match_findings
    report = Report(
        world_size=world_size,
        target=getattr(fn, "__name__", repr(fn)),
        findings=_dedupe(findings),
        schedules={r: [e.describe() for e in evs]
                   for r, evs in schedules.items()},
        events=schedules,
        comms=comms,
        cache_key=schedule_cache_key(schedules, world_size),
    )
    report.value_deps = world.value_deps
    report.results = world.results
    report.symmetry = symmetry
    return report


def check_program(path: str, world_size: int, timeout_s=None,
                  argv=None, module: bool = False) -> Report:
    """Verify a per-rank program file (or the module ``path`` under
    ``module=True``) in the virtual world (see :class:`VirtualWorld`):
    real values, recorded schedules, no processes, no live communication.
    ``argv`` becomes the program's ``sys.argv[1:]``, exactly as under the
    launcher.  ``report.seconds`` is the virtual world's wall time."""
    world = VirtualWorld(world_size, path, timeout_s=timeout_s, argv=argv,
                         module=module)
    report = world.run()
    report.findings = _dedupe(report.findings)
    report.symmetry = _maybe_partition(report.events, report.comms)
    report.seconds = world.seconds
    return report


def _maybe_partition(events_by_rank, comms):
    """The rank-symmetry partition of an extracted schedule set, when
    the knob allows, the world is big enough for the symbolic path to
    matter, and the program canonicalizes — else None.  Gated at
    ``SYMBOLIC_MIN_NP`` so small-world reports (and every golden) stay
    bit-for-bit what they always were."""
    from . import _symbolic

    if _symbolic.symbolic_mode() != "auto" \
            or len(events_by_rank) < SYMBOLIC_MIN_NP:
        return None
    try:
        return partition_schedules(events_by_rank, comms)
    except Uncanonicalizable:
        return None


def plan_report(report: Report, **kwargs) -> ExecutionPlan:
    """Compile the report's extracted schedules into a verified
    execution plan (see :mod:`._plan`): dependence analysis splits true
    data dependence from token serialization, the rewrite emits
    concurrency groups / hoisted recv posts / coalescing and bucket
    marks, and the equivalence prover replays both schedules through the
    match simulator before the plan may execute.  Attaches the plan to
    ``report.plan`` and returns it."""
    kwargs.setdefault("symmetry", getattr(report, "symmetry", None))
    plan = compile_schedules(
        report.events,
        report.comms or {(0,): tuple(range(report.world_size))},
        findings=report.findings,
        world_size=report.world_size,
        value_deps_by_rank=getattr(report, "value_deps", None),
        **kwargs,
    )
    report.plan = plan
    return plan


def plan_for(fn, *args, world_size: int = 2, **kwargs) -> ExecutionPlan:
    """:func:`check` + :func:`plan_report` in one step: statically
    verify ``fn`` and compile its verified execution plan.  The plan of
    an unverifiable schedule is the trivial (unrewritten) one, with the
    blocking findings recorded in ``plan.reasons``."""
    report = check(fn, *args, world_size=world_size, **kwargs)
    return plan_report(report)
