"""Launch a program as N world ranks, one process each.

    python -m mpi4jax_tpu_torch.runtime.launch -n 4 [--fake-hosts 'r0,r1|r2,r3'] \\
        [--hosts H0,H1,...] [--port P] [--timeout S] [--trace out.json] \\
        [--verify] [--plan] [--live] [--elastic [--elastic-policy P]] \\
        prog.py [args...]
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
  5 s), and the launcher exits with that rank's code, naming it and its
  last transport error in the post-mortem.  Every rank's stderr is
  forwarded verbatim, and its tail kept for the post-mortem: links that
  the transport healed in place (not rank deaths) and links it declared
  dead are named there (``_self_heal_outcomes``).
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
  verdict.  As ``:188-348, 487-495`` there.  With ``--elastic`` the file
  is a plan *bundle*: one verified plan per world size a shrinking job may
  pass through, np down to 2, each from its own analyzer run
  (``_bundle_shrink_ladder``, ``:204-268`` there), so that a recovery
  re-proves and keeps its plan (``bridge.rebuild``).
- ``--live``: every rank arms live re-tuning (``MPI4JAX_TPU_LIVE=auto``,
  ``live/``).
- ``--elastic [--elastic-policy shrink|respawn]`` (``:445-534, 570-720,
  838-896`` there): recovery supervision instead of fail-fast.  Every rank
  runs with ``MPI4JAX_TPU_ELASTIC=1``, the coordination directory
  (``_ELASTIC_DIR``), the policy, its ``_GENERATION`` and ``_SLOT``, and
  ``MPI4JAX_TPU_TIMEOUT_S`` and ``_CONNECT_TIMEOUT_S`` at 60 s unless set.
  A dead rank advances the world *generation*: the launcher writes
  ``gen_<n>.json`` atomically (the map from slot to dense new rank, -1 for
  a lost slot, the size, the lost slots, the policy, the hosts and the
  re-derived base port ``port + n * (np + 1)``), the survivors rebuild
  through ``elastic.recover``, and under ``respawn`` the dead slot's
  program starts again at full size.  After ``2 * np + 2`` generations, or
  with no survivor to shrink onto, it tears the job down as fail-fast
  does.  A job that finishes after recoveries exits 0, and the post-mortem
  names the generation reached, the slots lost (or respawned) and the step
  the job resumed from.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
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


def _pump_stderr(pipe, tail):
    """Forward one rank's stderr verbatim, keeping a tail for the
    post-mortem."""
    try:
        for line in iter(pipe.readline, b""):
            tail.append(line)
            try:
                sys.stderr.buffer.write(line)
                sys.stderr.buffer.flush()
            except Exception:  # a closed or replaced stderr loses the line
                pass
    finally:
        try:
            pipe.close()
        except Exception:
            pass


def _self_heal_outcomes(slot_tails):
    """The transport's self-healing lines in every slot's stderr tail
    (``native/tpucomm.cc``'s greppable contract): ``({slot: links healed
    in place}, [(slot, peer) of each link declared dead]``.  A slot that
    healed a transient fault is not a dead rank."""
    healed = {}
    dead_links = []
    for slot, tail in sorted(slot_tails.items()):
        for line in tail:
            raw = bytes(line)
            if re.search(rb"self-heal: link to r\d+ recovered", raw):
                healed[slot] = healed.get(slot, 0) + 1
            m = re.search(rb"self-heal: link to r(\d+) DEAD", raw)
            if m:
                dead_links.append((slot, int(m.group(1))))
    return healed, dead_links


def _last_native_error(tail):
    """The newest transport diagnostic in a rank's stderr tail, else its
    last non-empty line."""
    for line in reversed(tail):
        text = line.decode(errors="replace").strip()
        if "tpucomm" in text or "returned error code" in text:
            return text
    for line in reversed(tail):
        text = line.decode(errors="replace").strip()
        if text:
            return text
    return ""


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


def _bundle_shrink_ladder(prog: str, np_: int, prog_args, plan_path: str,
                          primary: dict, module=False, fake_hosts=None,
                          hosts=None) -> None:
    """Extend the verified plan at ``np_`` into a plan bundle with one
    verified plan for each size a shrinking job may pass through (np - 1
    down to 2), each from its own analyzer run in the ranks' environment
    (a shrunk world reads ``MPI4JAX_TPU_FAKE_HOSTS`` by its dense ranks, as
    the analyzer does at that size).  A size whose plan is not compiled,
    not proved or unrewritten is skipped with a notice: a recovery to it
    runs without a plan.  The bundle (``analysis/_plan.py``'s plan-bundle/1)
    replaces ``plan_path`` in place."""
    from ..analysis._plan import BUNDLE_FORMAT, BUNDLE_VERSION

    plans = {str(np_): primary}
    skipped = []
    for n2 in range(np_ - 1, 1, -1):
        fd, sub_path = tempfile.mkstemp(prefix="m4j_plan_", suffix=".json")
        os.close(fd)
        try:
            res = _emit_plan_at(prog, n2, prog_args, sub_path, module,
                                fake_hosts, hosts)
            if res.returncode not in (0, 3):
                skipped.append((n2, f"analyzer exit {res.returncode}"))
                continue
            with open(sub_path) as f:
                sub = json.load(f)
            if not (sub.get("proved") and sub.get("rewritten")):
                skipped.append((n2, "not proved" if not sub.get("proved")
                                else "unrewritten"))
                continue
            plans[str(n2)] = sub
        except Exception as e:
            skipped.append((n2, str(e)))
        finally:
            try:
                os.unlink(sub_path)
            except OSError:
                pass
    bundle = {
        "format": BUNDLE_FORMAT,
        "version": BUNDLE_VERSION,
        "analyzer_version": primary.get("analyzer_version", ""),
        "plans": plans,
    }
    tmp = f"{plan_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
    os.replace(tmp, plan_path)
    covered = sorted(int(n) for n in plans)
    print(f"[launch] --plan --elastic: plan bundle covers np={covered} — a "
          "shrink inside this range re-proves and keeps its plan",
          file=sys.stderr, flush=True)
    for n2, why in skipped:
        print(f"[launch] --plan --elastic: no plan for np={n2} ({why}); a "
              "shrink to that size runs the historic path",
              file=sys.stderr, flush=True)


def _preflight_plan(prog: str, np_: int, prog_args=(), module=False,
                    fake_hosts=None, hosts=None,
                    enforce_verify: bool = False, elastic: bool = False):
    """Compile and prove ``prog``'s execution plan before any rank is
    spawned.  Returns ``(rc, plan_path)``: a nonzero ``rc`` stops the
    launch (only with ``enforce_verify``, which folds ``--verify`` into
    this one analyzer run); an empty ``plan_path`` means the job runs
    without a plan: the compiler failed, or the plan is not proved or
    changes nothing (a plan that rewrites nothing would cost every op its
    bookkeeping for no overlap).  ``elastic`` extends the plan into the
    bundle of a shrinking world (``_bundle_shrink_ladder``)."""
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
    if elastic:
        _bundle_shrink_ladder(prog, np_, prog_args, plan_path, plan, module,
                              fake_hosts, hosts)
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
                    help="supervise for recovery instead of fail-fast: a "
                         "dead rank advances the world generation, the "
                         "survivors rebuild over a re-derived port block "
                         "(mpi4jax_tpu_torch.elastic.recover), and under "
                         "the respawn policy the dead slot's program starts "
                         "again.  A job that completes after recoveries "
                         "exits 0.  With --plan, the plan becomes a bundle "
                         "of one verified plan per world size down to 2")
    ap.add_argument("--elastic-policy", default=None,
                    choices=("shrink", "respawn"),
                    help="what --elastic does about a dead rank: shrink "
                         "(the survivors renumber densely into a smaller "
                         "world) or respawn (the dead slot starts again at "
                         "full size).  Default: MPI4JAX_TPU_ELASTIC_POLICY, "
                         "else shrink")
    ap.add_argument("-m", dest="module", action="store_true",
                    help="PROG is a module, run as each rank's program "
                         "(python -m)")
    ap.add_argument("prog", help="python program (or module under -m) "
                                 "to run")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.np < 1:
        ap.error("-n must be at least 1")
    if args.hosts:
        nhosts = len(args.hosts.split(","))
        if nhosts != args.np:
            ap.error(f"--hosts lists {nhosts} entries for {args.np} ranks")
    elastic_policy = None
    if args.elastic:
        elastic_policy = (args.elastic_policy
                          or os.environ.get("MPI4JAX_TPU_ELASTIC_POLICY")
                          or "shrink").strip()
        if elastic_policy not in ("shrink", "respawn"):
            ap.error(f"--elastic policy must be shrink or respawn, got "
                     f"{elastic_policy!r}")
    prog_args = args.args[1:] if args.args[:1] == ["--"] else args.args
    command = ["-m"] * args.module + [args.prog, *prog_args]
    plan_path = ""
    if args.plan:
        # one analyzer run serves both gates
        rc, plan_path = _preflight_plan(
            args.prog, args.np, prog_args, args.module, args.fake_hosts,
            args.hosts, enforce_verify=args.verify, elastic=args.elastic)
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
    elastic_dir = (tempfile.mkdtemp(prefix="m4j_elastic_")
                   if elastic_policy else None)
    procs = []
    pumps = []
    pending = {}       # slot -> its live process
    slot_tails = {}    # slot -> the stderr tail of its newest process
    in_spawn = [True]
    deferred = []

    def _on_sigterm(signum, frame):
        # during a spawn a signal is deferred, so the reap never misses a
        # rank that was just forked
        if in_spawn[0]:
            deferred.append(_Terminated)
        else:
            raise _Terminated

    def _spawn(slot, *, rank, size, port, gen):
        """One rank's process; ``slot`` is its launcher slot (stable across
        generations), ``rank`` the rank it bootstraps with."""
        env = rank_env(rank, size, port, jobid, args.fake_hosts, trace,
                       args.hosts, plan_path, args.live)
        if elastic_policy is not None:
            env["MPI4JAX_TPU_ELASTIC"] = "1"
            env["MPI4JAX_TPU_ELASTIC_DIR"] = elastic_dir
            env["MPI4JAX_TPU_ELASTIC_POLICY"] = elastic_policy
            env["MPI4JAX_TPU_GENERATION"] = str(gen)
            env["MPI4JAX_TPU_SLOT"] = str(slot)
            # recovery needs every blocking wait bounded: the poison frames
            # free most peers at once, but a peer parked on the dead rank's
            # socket needs the deadline (an operator's setting wins)
            env.setdefault("MPI4JAX_TPU_TIMEOUT_S", "60")
            env.setdefault("MPI4JAX_TPU_CONNECT_TIMEOUT_S", "60")
        p = subprocess.Popen([sys.executable, *command], env=env,
                             stderr=subprocess.PIPE)
        tail = collections.deque(maxlen=80)
        pump = threading.Thread(target=_pump_stderr, args=(p.stderr, tail),
                                daemon=True)
        pump.start()
        procs.append(p)
        pumps.append(pump)
        slot_tails[slot] = tail
        return p

    generation = 0
    deaths = []        # every rank death, in order
    lost_slots = []    # slots lost for good (shrink)
    # a program that crashes every time would respawn forever
    max_generations = 2 * args.np + 2

    def _announce(gen, members, port, policy):
        """Write the generation file the survivors poll for, atomically."""
        mapping = {str(s): i for i, s in enumerate(members)}
        for s in lost_slots:
            mapping.setdefault(str(s), -1)
        hosts = ""
        if args.hosts:
            hl = args.hosts.split(",")
            hosts = ",".join(hl[s] for s in members)
        spec = {"generation": gen, "size": len(members), "base_port": port,
                "map": mapping, "lost": list(lost_slots), "policy": policy,
                "hosts": hosts, "np0": args.np}
        path = os.path.join(elastic_dir, f"gen_{gen}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(spec, f)
        os.replace(tmp, path)
        return spec

    def _failover(slot, rc):
        """One dead rank under --elastic: advance the generation, announce
        the survivors and, under respawn, start the slot again.  False when
        there is nothing to recover onto (the caller then fails fast)."""
        nonlocal generation
        deaths.append(slot)
        if elastic_policy != "respawn":
            lost_slots.append(slot)
        generation += 1
        live = sorted(pending)
        err = _last_native_error(slot_tails.get(slot, ()))
        print(f"launch: elastic: rank slot {slot} died (exit code {rc})"
              + (f"; last error: {err}" if err else "")
              + f"; advancing to generation {generation} "
              f"({elastic_policy})", file=sys.stderr, flush=True)
        if generation > max_generations:
            print(f"launch: elastic: giving up after {generation - 1} "
                  "recoveries (generation cap); tearing the job down",
                  file=sys.stderr, flush=True)
            return False
        if not live and elastic_policy == "shrink":
            print("launch: elastic: no surviving rank to shrink onto",
                  file=sys.stderr, flush=True)
            return False
        new_port = base_port + generation * (args.np + 1)
        if elastic_policy == "respawn":
            members = sorted(set(live) | {slot})
            spec = _announce(generation, members, new_port, "respawn")
            in_spawn[0] = True
            try:
                pending[slot] = _spawn(slot, rank=spec["map"][str(slot)],
                                       size=len(members), port=new_port,
                                       gen=generation)
            finally:
                in_spawn[0] = False
            if deferred:
                raise deferred[0]
        else:
            _announce(generation, live, new_port, "shrink")
        return True

    # a launcher run from a thread (concurrent jobs) keeps the process's
    # handler: signal handlers belong to the main thread
    main_thread = threading.current_thread() is threading.main_thread()
    old_term = (signal.signal(signal.SIGTERM, _on_sigterm) if main_thread
                else None)
    exit_code = 0
    first_fail = None
    watchdog_fired = False
    t_start = time.time()
    try:
        for rank in range(args.np):
            pending[rank] = _spawn(rank, rank=rank, size=args.np,
                                   port=base_port, gen=0)
        in_spawn[0] = False
        if deferred:
            raise deferred[0]
        while pending:
            dead = [(slot, rc) for slot, rc in
                    ((s, p.poll()) for s, p in pending.items())
                    if rc is not None]
            if any(rc != 0 for _, rc in dead):
                # a cascade lands milliseconds after its cause: one short
                # beat collects the whole wave before naming the first
                time.sleep(0.08)
                for slot, p in pending.items():
                    rc = p.poll()
                    if rc is not None and (slot, rc) not in dead:
                        dead.append((slot, rc))
            aborted = False
            for slot, rc in sorted(dead):
                if slot not in pending:
                    continue
                del pending[slot]
                if rc == 0:
                    continue
                if first_fail is None:
                    first_fail = (slot, rc)
                if elastic_policy is not None and _failover(slot, rc):
                    continue
                exit_code = rc
                _terminate_group(list(pending.values()))
                pending.clear()
                aborted = True
                break
            if aborted:
                break
            if pending and args.timeout is not None \
                    and time.time() - t_start > args.timeout:
                watchdog_fired = True
                print(f"launch: watchdog: wall-clock timeout after "
                      f"{args.timeout:g} s; terminating rank(s) "
                      f"{sorted(pending)}", file=sys.stderr, flush=True)
                _terminate_group(list(pending.values()))
                pending.clear()
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
        for pump in pumps:
            pump.join(timeout=2.0)
        if plan_path:
            try:
                os.unlink(plan_path)
            except OSError:
                pass
    if trace:
        _merge_trace(trace, args.np)
    _post_mortem(args, exit_code, first_fail, watchdog_fired, slot_tails,
                 elastic_policy, generation, deaths, lost_slots)
    if elastic_dir is not None:
        shutil.rmtree(elastic_dir, ignore_errors=True)
    return exit_code


def _post_mortem(args, exit_code, first_fail, watchdog_fired, slot_tails,
                 elastic_policy, generation, deaths, lost_slots) -> None:
    """The launcher's last line about the job: the recovery outcome of an
    elastic job that survived, else the rank that failed first, else the
    watchdog, each with the links healed or declared dead."""
    healed, dead_links = _self_heal_outcomes(slot_tails)
    heal_note = ""
    if healed:
        heal_note = (f"; transient link fault(s) healed in-place on rank "
                     f"slot(s) {sorted(healed)} ({sum(healed.values())} "
                     "reconnect(s), not rank deaths)")
    link_note = ""
    if dead_links:
        link_note = "; failed link(s): " + ", ".join(
            f"rank {s} -> rank {p}" for s, p in dead_links)
    if elastic_policy is not None and generation > 0 and exit_code == 0:
        steps = [int(m.group(1)) for tail in slot_tails.values()
                 for line in tail
                 for m in [re.search(rb"resum\w+ from step (\d+)",
                                     bytes(line))] if m]
        resume = (f", resumed from step {max(steps)}" if steps
                  else ", no checkpoint resume reported")
        # a respawned slot died but finished: not lost
        outcome = (f"lost rank slot(s) {lost_slots}"
                   if elastic_policy != "respawn" else
                   f"rank death(s) at slot(s) {deaths} (respawned)")
        print(f"launch: post-mortem: elastic job completed after recovery "
              f"(policy {elastic_policy}): reached generation "
              f"{generation}, {outcome}{resume}{link_note}{heal_note}",
              file=sys.stderr, flush=True)
    elif first_fail is not None:
        rank, rc = first_fail
        err = _last_native_error(slot_tails.get(rank, ()))
        gen_note = (f" after reaching generation {generation} (death(s) at "
                    f"slot(s) {deaths})"
                    if elastic_policy is not None and generation > 0 else "")
        print(f"launch: post-mortem: rank {rank} failed first (exit code "
              f"{rc}){gen_note}" + (f"; last error: {err}" if err else "")
              + link_note + heal_note, file=sys.stderr, flush=True)
    elif healed:
        print("launch: post-mortem: job completed; no rank failed"
              + heal_note.replace("; ", " — ", 1), file=sys.stderr,
              flush=True)
    elif watchdog_fired:
        print("launch: post-mortem: no rank failed — the job outlived the "
              f"--timeout watchdog ({args.timeout:g} s); a transport wait "
              "with MPI4JAX_TPU_TIMEOUT_S unset looks exactly like this",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
