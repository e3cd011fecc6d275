"""Launch a program as N world ranks, one process each.

    python -m mpi4jax_tpu_torch.runtime.launch -n 4 [--fake-hosts 'r0,r1|r2,r3'] \\
        [--hosts H0,H1,...] [--port P] [--timeout S] [--trace out.json] \\
        [--verify] [--plan] [--live] prog.py [args...]
    python -m mpi4jax_tpu_torch.runtime.launch -n 4 -m package.module [-- args...]

The counterpart of ``mpi4jax_tpu/runtime/launch.py`` for the port.  Each
rank runs ``prog.py`` (or ``python -m package.module`` under ``-m``) with ``MPI4JAX_TPU_RANK`` / ``SIZE`` / ``COORD`` /
``JOBID`` set (and ``MPI4JAX_TPU_FAKE_HOSTS`` under ``--fake-hosts``,
``MPI4JAX_TPU_HOSTS`` under ``--hosts``);
``transport.get_world_comm()`` then returns its ``WorldComm``.  The ranks
share this host; on a machine with one card they all use it.

- The base port defaults to a block of N free ports on this host, so
  several jobs can run side by side.
- Fail-fast: when a rank exits non-zero the others are sent SIGTERM, then
  SIGKILL after a grace period (``MPI4JAX_TPU_LAUNCH_GRACE_S``, default
  5 s), and the launcher exits with that rank's code, naming it.
- ``--timeout S``: after S seconds the whole group is reaped the same way
  and the launcher exits 124.  SIGTERM to the launcher reaps the group and
  exits 143.
- ``--trace OUT.json``: every rank records its per-op events
  (``MPI4JAX_TPU_TRACE``, ``obs/``) and dumps ``OUT.json.rank<r>.json`` at
  exit; after the job the launcher merges the parts into one
  Perfetto-loadable Chrome trace at ``OUT.json`` (stale parts at that path
  are removed first), as ``mpi4jax_tpu/runtime/launch.py:351-390`` there.
- ``--verify``: before any rank is spawned, the static communication
  verifier (``python -m mpi4jax_tpu_torch.analyze ... --errors-only``) runs
  the program in its virtual world, in a subprocess, with the environment
  the ranks will get (``--fake-hosts``, ``--hosts``, the tune cache).
  Warnings are printed and the launch goes on; error findings are printed
  and the launcher exits 3 with no rank spawned; an analyzer failure exits
  with the analyzer's code.  As ``mpi4jax_tpu/runtime/launch.py:143-185``
  there, with ``-m`` too.
- ``--plan``: before any rank is spawned, the schedule compiler (``python
  -m mpi4jax_tpu_torch.analyze ... --emit-plan``) compiles and proves the
  program's execution plan in the same environment, and every rank runs
  with ``MPI4JAX_TPU_PLAN`` naming it (``runtime/planrt.py``).  A plan
  that is not proved, or changes nothing, runs the job without one, with
  a notice; with ``--verify`` the same analyzer run also enforces the
  verdict.  As ``:188-348, 487-495`` there.  ``--plan --elastic`` (the
  plan bundle of a shrinking world) comes with the elastic slice of the
  port, and the launcher refuses it.
- ``--live``: every rank arms live re-tuning (``MPI4JAX_TPU_LIVE=auto``,
  ``live/``).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
import uuid

from .transport import _free_port_block


def _grace_s() -> float:
    try:
        return max(0.1, float(os.environ.get("MPI4JAX_TPU_LAUNCH_GRACE_S",
                                             "5")))
    except ValueError:
        return 5.0


class _Terminated(Exception):
    """Raised by the SIGTERM handler to unwind into the reap."""


def _terminate_group(procs):
    """SIGTERM every live rank, wait up to the grace period, SIGKILL the
    rest, and reap every process."""
    grace = _grace_s()
    live = [p for p in procs if p.poll() is None]
    for p in live:
        try:
            p.terminate()
        except OSError:
            pass
    deadline = time.time() + grace
    for p in live:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            try:
                p.kill()
            except OSError:
                pass
            p.wait()


def rank_env(rank: int, size: int, base_port: int, jobid: str,
             fake_hosts=None, trace=None, hosts=None, plan=None,
             live=False) -> dict:
    """The environment of one rank."""
    env = dict(os.environ)
    env["MPI4JAX_TPU_RANK"] = str(rank)
    env["MPI4JAX_TPU_SIZE"] = str(size)
    env["MPI4JAX_TPU_COORD"] = f"127.0.0.1:{base_port}"
    env["MPI4JAX_TPU_JOBID"] = jobid
    if fake_hosts:
        env["MPI4JAX_TPU_FAKE_HOSTS"] = fake_hosts
    if hosts:
        env["MPI4JAX_TPU_HOSTS"] = hosts
    if trace:
        env["MPI4JAX_TPU_TRACE"] = trace
    if plan:
        env["MPI4JAX_TPU_PLAN"] = plan
    if live:
        env["MPI4JAX_TPU_LIVE"] = "auto"
    return env


def _preflight_verify(prog: str, np_: int, prog_args=(), module=False,
                      fake_hosts=None, hosts=None) -> int:
    """Run the static communication verifier on ``prog`` before spawning
    any rank.  Returns 0 to proceed; 3 (with the findings table on
    stderr) when verification fails; the analyzer's own code on analyzer
    errors.

    A subprocess on purpose: a verifier crash must not take the launcher
    down with it, and the analyzed program's process state stays out of
    the launcher.  Its environment is the ranks' without the per-rank
    variables: the virtual world gives each rank its comm, and records
    nothing (no ``MPI4JAX_TPU_TRACE``).
    """
    env = dict(os.environ)
    if fake_hosts:
        env["MPI4JAX_TPU_FAKE_HOSTS"] = fake_hosts
    if hosts:
        env["MPI4JAX_TPU_HOSTS"] = hosts
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env.setdefault("PYTHONPATH", repo)
    # warnings document assumptions and do not block a launch; the "--"
    # keeps the program's own flags out of the analyzer's parser
    res = subprocess.run(
        [sys.executable, "-m", "mpi4jax_tpu_torch.analyze",
         *(["-m"] if module else []), prog, "--np", str(np_),
         "--errors-only", "--", *prog_args],
        capture_output=True, text=True, env=env,
    )
    if res.returncode == 0:
        if "WARNING" in res.stdout:
            print(f"[launch] --verify: {prog} has warnings at np={np_} "
                  "(launch proceeds):", file=sys.stderr)
            sys.stderr.write(res.stdout)
        else:
            print(f"[launch] --verify: {prog} clean at np={np_}",
                  file=sys.stderr)
        sys.stderr.flush()
        return 0
    if res.returncode == 3:
        print(f"[launch] --verify FAILED for {prog} at np={np_} — "
              "no rank was spawned:", file=sys.stderr)
        sys.stderr.write(res.stdout)
        sys.stderr.write(res.stderr)
        sys.stderr.flush()
        return 3
    print(f"[launch] --verify could not run the analyzer "
          f"(exit {res.returncode}):", file=sys.stderr)
    sys.stderr.write(res.stderr[-2000:])
    sys.stderr.flush()
    return res.returncode or 2


def _emit_plan_at(prog: str, np_: int, prog_args, plan_path: str,
                  module=False, fake_hosts=None, hosts=None):
    """One ``analyze --emit-plan`` run at world size ``np_``; returns the
    CompletedProcess (the caller reads its exit code)."""
    env = dict(os.environ)
    if fake_hosts:
        env["MPI4JAX_TPU_FAKE_HOSTS"] = fake_hosts
    if hosts:
        env["MPI4JAX_TPU_HOSTS"] = hosts
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env.setdefault("PYTHONPATH", repo)
    return subprocess.run(
        [sys.executable, "-m", "mpi4jax_tpu_torch.analyze",
         *(["-m"] if module else []), prog, "--np", str(np_),
         "--errors-only", "--emit-plan", plan_path, "--", *prog_args],
        capture_output=True, text=True, env=env,
    )


def _preflight_plan(prog: str, np_: int, prog_args=(), module=False,
                    fake_hosts=None, hosts=None,
                    enforce_verify: bool = False):
    """Compile and prove ``prog``'s execution plan before any rank is
    spawned.  Returns ``(rc, plan_path)``: a nonzero ``rc`` stops the
    launch (only with ``enforce_verify``, which folds ``--verify`` into
    this one analyzer run); an empty ``plan_path`` means the job runs
    without a plan: the compiler failed, or the plan is not proved or
    changes nothing (a plan that rewrites nothing would cost every op its
    bookkeeping for no overlap)."""
    import json
    import tempfile

    fd, plan_path = tempfile.mkstemp(prefix="m4j_plan_", suffix=".json")
    os.close(fd)
    res = _emit_plan_at(prog, np_, prog_args, plan_path, module,
                        fake_hosts, hosts)
    if res.returncode == 3 and enforce_verify:
        print(f"[launch] --verify FAILED for {prog} at np={np_} — "
              "no rank was spawned:", file=sys.stderr)
        sys.stderr.write(res.stdout)
        sys.stderr.write(res.stderr)
        sys.stderr.flush()
        os.unlink(plan_path)
        return 3, ""
    if enforce_verify and res.returncode == 0 and "WARNING" in res.stdout:
        print(f"[launch] --verify: {prog} has warnings at np={np_} "
              "(launch proceeds):", file=sys.stderr)
        sys.stderr.write(res.stdout)
        sys.stderr.flush()
    if res.returncode not in (0, 3):
        os.unlink(plan_path)
        if enforce_verify:
            print(f"[launch] --verify could not run the analyzer "
                  f"(exit {res.returncode}):", file=sys.stderr)
            sys.stderr.write(res.stderr[-2000:])
            sys.stderr.flush()
            return res.returncode or 2, ""
        print(f"[launch] --plan: schedule compiler could not run "
              f"(exit {res.returncode}); running without a plan:",
              file=sys.stderr)
        sys.stderr.write(res.stderr[-2000:])
        sys.stderr.flush()
        return 0, ""
    try:
        with open(plan_path) as f:
            plan = json.load(f)
        proved = bool(plan.get("proved"))
        rewritten = bool(plan.get("rewritten"))
        reasons = plan.get("reasons", [])
    except Exception as e:
        print(f"[launch] --plan: cannot read compiled plan: {e}",
              file=sys.stderr, flush=True)
        os.unlink(plan_path)
        return 0, ""
    if not (proved and rewritten):
        state = "NOT proved equivalent" if not proved else "unrewritten"
        print(f"[launch] --plan: plan for {prog} at np={np_} is "
              f"{state}; running without a plan:"
              + "".join(f"\n    {r}" for r in reasons),
              file=sys.stderr, flush=True)
        os.unlink(plan_path)
        return 0, ""
    print(f"[launch] --plan: verified plan "
          f"{plan.get('cache_key', '?')} for {prog} at np={np_}"
          + "".join(f"\n    note: {r}" for r in reasons),
          file=sys.stderr, flush=True)
    return 0, plan_path


def _remove_stale_parts(trace: str) -> None:
    """Parts left at ``trace`` by an earlier run (perhaps of another world
    size) must not leak into this run's merge or ``tune --from-trace``."""
    import glob

    for stale in glob.glob(f"{glob.escape(trace)}.rank*.json"):
        try:
            os.unlink(stale)
        except OSError:
            pass


def _merge_trace(out_path: str, np_: int) -> None:
    """Merge the ranks' recordings into one Chrome trace at ``out_path``.
    Best effort: a failed job may have dumped only some parts, and the
    line says how many were found."""
    import json

    from .. import obs

    parts = obs.part_paths(out_path)
    if not parts:
        print(f"launch: --trace: no recordings found at "
              f"{out_path}.rank*.json (did the ranks reach comm init?)",
              file=sys.stderr, flush=True)
        return
    try:
        merged = obs.merge_files(parts)
        with open(out_path, "w") as f:
            json.dump(merged, f)
        spans = sum(1 for e in merged["traceEvents"] if e.get("ph") == "X")
        print(f"launch: --trace: merged {len(parts)}/{np_} rank "
              f"recording(s), {spans} spans -> {out_path} "
              "(load in https://ui.perfetto.dev)",
              file=sys.stderr, flush=True)
    except Exception as e:
        print(f"launch: --trace: merge failed: {e}", file=sys.stderr,
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi4jax_tpu_torch.runtime.launch",
        description="run a program as N world ranks")
    ap.add_argument("-n", "--np", type=int, required=True,
                    help="number of ranks")
    ap.add_argument("--port", type=int, default=None,
                    help="base TCP port (rank r listens on port + r; "
                         "default: a free block on this host)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="reap the whole group after this many seconds "
                         "and exit 124")
    ap.add_argument("--fake-hosts", default=None, metavar="SPEC",
                    help="virtual host partition ('r0,r1|r2,r3': ranks 0-1 "
                         "and 2-3 form two islands), exported to every "
                         "rank as MPI4JAX_TPU_FAKE_HOSTS")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated per-rank host list for the native "
                         "transport, one entry per rank (default: every "
                         "rank on 127.0.0.1), exported to every rank as "
                         "MPI4JAX_TPU_HOSTS.  Rank i listens on hosts[i]; "
                         "the launcher still spawns every rank here (the "
                         "list is for multi-homed hosts and loopback "
                         "aliases).  The JAX launcher's --platform, which "
                         "sets JAX_PLATFORMS, has no torch meaning: a "
                         "rank's device is its program's choice")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record every rank's per-op events "
                         "(MPI4JAX_TPU_TRACE) and merge them into one "
                         "Perfetto-loadable Chrome trace at OUT.json after "
                         "the job; the ranks' parts stay beside it as "
                         "OUT.json.rank<r>.json")
    ap.add_argument("--verify", action="store_true",
                    help="pre-flight: statically verify the program's "
                         "communication schedule (python -m "
                         "mpi4jax_tpu_torch.analyze) and exit 3 with the "
                         "findings table when it fails — BEFORE any rank "
                         "is spawned")
    ap.add_argument("--plan", action="store_true",
                    help="pre-flight: compile the program's communication "
                         "schedule into a verified execution plan (python "
                         "-m mpi4jax_tpu_torch.analyze --emit-plan) and run "
                         "every rank with MPI4JAX_TPU_PLAN naming it: "
                         "hoisted receive posts and deferred send "
                         "completions on the progress engine.  A plan that "
                         "is not proved runs the job without one, with a "
                         "notice")
    ap.add_argument("--live", action="store_true",
                    help="arm live drift detection and collective "
                         "re-tuning in every rank (MPI4JAX_TPU_LIVE=auto; "
                         "thresholds MPI4JAX_TPU_LIVE_WINDOW, _DRIFT_PCT, "
                         "_COOLDOWN_OPS)")
    ap.add_argument("--elastic", action="store_true",
                    help="not in the port yet: recovery from a dead rank, "
                         "and --plan --elastic's plan bundle, come with its "
                         "elastic slice")
    ap.add_argument("-m", dest="module", action="store_true",
                    help="PROG is a module, run as each rank's program "
                         "(python -m)")
    ap.add_argument("prog", help="python program (or module under -m) "
                                 "to run")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.np < 1:
        ap.error("-n must be at least 1")
    if args.elastic:
        ap.error(("--plan --elastic" if args.plan else "--elastic")
                 + " is not ported yet: elastic recovery and the plan "
                   "bundle of a shrinking world come with the port's "
                   "elastic slice (elastic/, bridge.rebuild)")
    if args.hosts:
        nhosts = len(args.hosts.split(","))
        if nhosts != args.np:
            ap.error(f"--hosts lists {nhosts} entries for {args.np} ranks")
    prog_args = args.args[1:] if args.args[:1] == ["--"] else args.args
    command = ["-m"] * args.module + [args.prog, *prog_args]
    plan_path = ""
    if args.plan:
        # one analyzer run serves both gates
        rc, plan_path = _preflight_plan(
            args.prog, args.np, prog_args, args.module, args.fake_hosts,
            args.hosts, enforce_verify=args.verify)
        if rc != 0:
            return rc
    elif args.verify:
        rc = _preflight_verify(args.prog, args.np, prog_args, args.module,
                               args.fake_hosts, args.hosts)
        if rc != 0:
            return rc

    trace = os.path.abspath(args.trace) if args.trace else None
    if trace:
        _remove_stale_parts(trace)
    base_port = args.port or _free_port_block(args.np)
    # job-unique token for the transport's shared-memory names
    jobid = uuid.uuid4().hex[:16]
    procs = []
    in_spawn = [True]
    deferred = []

    def _on_sigterm(signum, frame):
        # during the spawn loop a signal is deferred, so the reap never
        # misses a rank that was just forked
        if in_spawn[0]:
            deferred.append(_Terminated)
        else:
            raise _Terminated

    # a launcher run from a thread (concurrent jobs) keeps the process's
    # handler: signal handlers belong to the main thread
    main_thread = threading.current_thread() is threading.main_thread()
    old_term = (signal.signal(signal.SIGTERM, _on_sigterm) if main_thread
                else None)
    exit_code = 0
    first_fail = None
    t_start = time.time()
    try:
        for rank in range(args.np):
            procs.append(subprocess.Popen(
                [sys.executable, *command],
                env=rank_env(rank, args.np, base_port, jobid,
                             args.fake_hosts, trace, args.hosts,
                             plan_path, args.live)))
        in_spawn[0] = False
        if deferred:
            raise deferred[0]
        pending = dict(enumerate(procs))
        while pending:
            for rank, p in list(pending.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del pending[rank]
                if rc != 0 and first_fail is None:
                    first_fail = (rank, rc)
            if first_fail is not None:
                exit_code = first_fail[1]
                _terminate_group(list(pending.values()))
                break
            if args.timeout is not None \
                    and time.time() - t_start > args.timeout:
                print(f"launch: watchdog: wall-clock timeout after "
                      f"{args.timeout:g} s; terminating rank(s) "
                      f"{sorted(pending)}", file=sys.stderr, flush=True)
                _terminate_group(list(pending.values()))
                exit_code = 124
                break
            time.sleep(0.02)
    except (_Terminated, KeyboardInterrupt) as e:
        if main_thread:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
        _terminate_group(procs)
        exit_code = 143 if isinstance(e, _Terminated) else 130
    except BaseException:
        # e.g. a failed spawn: no rank outlives the launcher
        _terminate_group(procs)
        raise
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, old_term)
    if plan_path:
        try:
            os.unlink(plan_path)
        except OSError:
            pass
    if trace:
        _merge_trace(trace, args.np)
    if first_fail is not None:
        print(f"launch: post-mortem: rank {first_fail[0]} failed first "
              f"(exit code {first_fail[1]})", file=sys.stderr, flush=True)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
