"""Offline collective autotuner CLI.

    python -m mpi4jax_tpu_torch.tune [--np 4] [--sizes 1024,...,16777216]
                                     [--repeats N] [--ops allreduce,alltoall]
                                     [--cache PATH] [--port P] [--device D]
    python -m mpi4jax_tpu_torch.tune --from-trace out.json.rank0.json[,...]
    python -m mpi4jax_tpu_torch.tune --joint [--topk 3] [--model-out PATH]
                                     [--from-trace REC[,...]] [sweep options]

The counterpart of ``mpi4jax_tpu/tune/__main__.py``.  It sweeps every
selectable algorithm for each (op, payload size) on a live job and writes
the winners to the persistent cache (``tune.cache_path``), which
``tune.install`` loads at comm creation.  Three modes:

- **outer** (outside a world job): re-executes this file under the port's
  launcher at ``--np`` ranks with the shm arena disabled
  (``MPI4JAX_TPU_DISABLE_SHM=1``; under ``MPI4JAX_TPU_FAKE_HOSTS`` the
  virtual host split already withholds the world arena), without
  ``MPI4JAX_TPU_COLL_ALGO``, and with ``MPI4JAX_TPU_ICI_LEG=off``, so that
  an ``hring``/``htree`` row times the transport's own schedule and not
  the intra-island leg on the card;
- **rank** (inside a world job): the one-axis sweep over the native
  transport on numpy buffers (each sample starts from a barrier; the
  median of ``--repeats`` is maxed across ranks with a MAX allreduce, so
  every rank names the same winner), and rank 0 writes the cache
  atomically; the hierarchical rows run only on a multi-island topology;
- **--from-trace**: the cache from a recorded real run's timings
  (``tune.cache_from_trace``): recordings from superseded world
  generations are ignored, and a recording without TCP-path collective
  timings is refused.

``--device`` names where the ranks' world comm lives (default ``cuda``):
the sweep's buffers stay in host memory either way, but the device sets
the topology's tiers and so the cache's topology fingerprint.

``--joint`` replaces the one-axis sweep with the joint search
(``_joint.py``, as ``mpi4jax_tpu/tune/__main__.py:356-612`` there):
algorithm x quantization x topology combinations compete in one space,
seeded by a cost model (``_model.py``) fitted from anchor measurements
(and, with ``--from-trace``, from recordings) and refined by measuring the
model's ``--topk`` per size.  The driver runs one sub-job for the combos
that a call can force, and on a multi-island topology one sub-job per gate
set of the gated combos: ``+q`` under ``MPI4JAX_TPU_COLL_QUANT=force``,
``+ici`` under ``MPI4JAX_TPU_ICI_LEG=force`` (the intra-island leg on the
card: kernel 3 folds each island, kernel 4 packs the quantized frames),
and both.  A rank drops any combo whose label would time another schedule
under its gates (``_runs_as_labeled``); where the base sub-job found the
leg on, the driver skips a gated sub-job of hierarchical combos without
the leg's gate, whose every combo the ranks would drop (the JAX driver
launches it and it measures nothing).  The merged winners become one v2
cache of winning combinations per size band (``tune.cache_from_joint``)
plus the fitted cost-model file (``_model.model_path``, or
``MPI4JAX_TPU_TUNE_MODEL``, or ``--model-out``).  Per sub-job the driver
prints one JSON line: its gates, combos, wall seconds, rows and the
launches of kernels 3 and 4 summed over its ranks (a skipped one: its
gates, combos and ``skipped``, the reason).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

if __package__ in (None, ""):  # run as a file by the launcher
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from mpi4jax_tpu_torch import tune  # noqa: E402

# native wire codes (native/tpucomm.h): f32 11, f64 12; SUM 0, MAX 2
_F32, _F64 = 11, 12
_SUM, _MAX = 0, 2

DEFAULT_SIZES = [1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10,
                 1 << 20, 4 << 20, 16 << 20]
#: algorithms swept per op (f32 SUM payloads, so the quantized schedules
#: are eligible and measured for allreduce and alltoall)
CANDIDATES = {
    "allreduce": ("ring", "rd", "tree", "qring", "qrd"),
    "allgather": ("ring", "rd", "tree"),
    "alltoall": ("ring", "qalltoall"),
}


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpi4jax_tpu_torch.tune")
    ap.add_argument("--np", type=int, default=None, dest="np_",
                    help="ranks to tune for (outer mode; default 4).  "
                         "With --from-trace: override the recording's own "
                         "world size")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated payload byte sizes "
                         "(default: 1KB..16MB, x4 apart)")
    ap.add_argument("--repeats", type=int, default=0,
                    help="timed iterations per point (0 = by size)")
    ap.add_argument("--ops", default="allreduce,allgather,alltoall")
    ap.add_argument("--cache", default=None,
                    help="cache file path (default: tune.cache_path(np))")
    ap.add_argument("--port", type=int, default=None,
                    help="launcher base port (outer mode)")
    ap.add_argument("--device", default="cuda",
                    help="device of the ranks' world comm (default cuda)")
    ap.add_argument("--from-trace", default=None, metavar="REC[,REC...]",
                    help="derive the cache from recorded runs instead of a "
                         "sweep: comma-separated part files "
                         "(out.json.rank*.json) and/or merged traces "
                         "(globs allowed)")
    ap.add_argument("--joint", action="store_true",
                    help="search the joint algorithm x quantization x "
                         "topology space (model-seeded, measurement-"
                         "refined) and write a v2 cache of the winning "
                         "combination per size band, plus the fitted "
                         "cost-model file")
    ap.add_argument("--topk", type=int, default=3,
                    help="--joint: combos measured per non-anchor size (the "
                         "model's best k predictions; combos it has never "
                         "seen are always measured)")
    ap.add_argument("--model-out", default=None,
                    help="--joint: cost-model output path (default: "
                         "MPI4JAX_TPU_TUNE_MODEL, else "
                         "tune._model.model_path(np))")
    # plumbing between the --joint driver and its sub-jobs
    ap.add_argument("--joint-out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--joint-combos", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--joint-model", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _trace_paths(spec: str):
    paths = []
    for piece in spec.split(","):
        piece = piece.strip()
        if not piece:
            continue
        hits = sorted(glob.glob(piece))
        if not hits:
            raise FileNotFoundError(
                f"--from-trace: no file matches {piece!r}")
        paths.extend(hits)
    return paths


def _from_trace(args) -> int:
    try:
        paths = _trace_paths(args.from_trace)
    except FileNotFoundError as e:
        print(f"tune: {e}", file=sys.stderr, flush=True)
        return 2
    try:
        cache = tune.cache_from_trace(
            paths, world_size=args.np_, cache_path_override=args.cache)
    except (ValueError, OSError) as e:
        print(f"tune: --from-trace: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"tune: cache written to {cache} (from {len(paths)} "
          "recording file(s))")
    return 0


def _outer(args) -> int:
    """Re-run this file under the launcher, then report the cache."""
    np_ = args.np_ or 4
    cmd = [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch",
           "-n", str(np_)]
    if args.port:
        cmd += ["--port", str(args.port)]
    cmd += [os.path.abspath(__file__)] + _sweep_args(args)
    # only an explicit path is forwarded: the default may be keyed on the
    # topology, which only the ranks know (rank 0 prints where it wrote)
    if args.cache:
        cmd += ["--cache", args.cache]
    env = dict(os.environ)
    if not os.environ.get("MPI4JAX_TPU_FAKE_HOSTS", "").strip():
        env["MPI4JAX_TPU_DISABLE_SHM"] = "1"
    env.pop("MPI4JAX_TPU_COLL_ALGO", None)
    env["MPI4JAX_TPU_ICI_LEG"] = "off"
    rc = subprocess.run(cmd, env=env).returncode
    if rc == 0 and args.cache:
        print(f"tune: cache written to {args.cache}")
    return rc


def _time_point(comm, bridge, np, op, nbytes, algo, repeats):
    """The median wall time of ``repeats`` forced-``algo`` calls, each
    started from a barrier, maxed across ranks."""
    code = tune.ALGO_CODES[algo]
    h = comm.handle
    if op == "allreduce":
        x = np.ones(max(nbytes // 4, 1), np.float32)
        out = np.empty_like(x)

        def run():
            bridge.allreduce_raw(h, x, out, _F32, _SUM, algo=code)
    elif op == "alltoall":
        # nbytes is the whole send buffer: size rows of nbytes / size
        x = np.ones((comm.size(), max(nbytes // 4 // comm.size(), 1)),
                    np.float32)
        out = np.empty_like(x)

        def run():
            bridge.alltoall(h, x, out, code, _F32)
    else:
        x = np.ones(max(nbytes // 4, 1), np.float32)
        out = np.empty((comm.size(),) + x.shape, np.float32)

        def run():
            bridge.allgather_raw(h, x, out, algo=code)

    run()  # warm-up, and every rank at the same op count
    times = []
    for _ in range(max(repeats, 3)):
        bridge.barrier(h)  # outside the timed window, for every algo
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    dt = (times[(n - 1) // 2] + times[n // 2]) / 2.0
    agreed = np.empty(1, np.float64)
    bridge.allreduce_raw(h, np.array([dt], np.float64), agreed, _F64, _MAX)
    return float(agreed[0])


def _rank(args) -> int:
    import numpy as np

    from mpi4jax_tpu_torch import topo as _topo
    from mpi4jax_tpu_torch.runtime import bridge, transport
    from mpi4jax_tpu_torch.utils.config import hier_mode, quant_mode

    comm = transport.get_world_comm(device=args.device)
    n = comm.size()
    if bridge.shm_active(comm.handle) and comm.rank() == 0:
        print("tune: WARNING: the shm arena is active; collectives take the "
              "same-host fast path and every algorithm measures alike (run "
              "through the outer mode, which disables the arena)",
              file=sys.stderr, flush=True)
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes
             else DEFAULT_SIZES)
    ops = [tune._check_op(o.strip()) for o in args.ops.split(",")
           if o.strip()]
    topology = _topo.get_topology(comm.handle)
    # the hierarchical rows run for real only on a multi-island topology
    hier_ok = topology is not None and topology.multi \
        and hier_mode() != "deny"
    measurements = []
    best = {op: {} for op in ops}
    for op in ops:
        for nbytes in sizes:
            repeats = args.repeats or max(7, min(30, int(3e6 / max(nbytes,
                                                                   1))))
            cands = CANDIDATES[op]
            if hier_ok:
                extra = (("halltoall", "hqalltoall") if op == "alltoall"
                         else ("hring", "htree"))
                cands = cands + tuple(a for a in extra if a not in cands)
            if quant_mode() == "deny":
                cands = tuple(a for a in cands
                              if a not in tune.QUANT_ALGOS
                              and a not in tune.A2A_QUANT)
            per_algo = {}
            for algo in cands:
                dt = _time_point(comm, bridge, np, op, nbytes, algo, repeats)
                per_algo[algo] = dt
                measurements.append({"op": op, "bytes": nbytes, "algo": algo,
                                     "seconds": round(dt, 9), "ranks": n})
            winner = min(per_algo, key=per_algo.get)
            best[op][nbytes] = winner
            if comm.rank() == 0:
                print(json.dumps({
                    "op": op, "bytes": nbytes, "winner": winner,
                    "seconds": {a: round(t, 9) for a, t in per_algo.items()},
                }), flush=True)
    if comm.rank() == 0:
        table = {op: tune.entries_from_measurements(best[op]) for op in ops}
        # a multi-island sweep's winners hold on that shape only
        topo_fp = (topology.fingerprint()
                   if topology is not None and topology.multi else None)
        path = tune.save_cache(n, table, measurements, path=args.cache,
                               topo_fingerprint=topo_fp)
        print(f"tune: wrote {path}", flush=True)
    bridge.barrier(comm.handle)  # the cache is on disk before any exit
    return 0


def _sweep_args(args):
    """The sweep options a driver forwards to its ranks."""
    out = ["--device", args.device]
    for flag, val in (("--sizes", args.sizes),
                      ("--repeats", args.repeats or None),
                      ("--ops", args.ops)):
        if val:
            out += [flag, str(val)]
    return out


def _joint_rank(args) -> int:
    """One rank of the joint search: every rank runs the same model-seeded
    search (each point's time is MAX-agreed across the ranks, so the search
    and its winners agree), and rank 0 hands the rows, with the launches of
    kernels 3 and 4 summed over the ranks, back to the driver."""
    import numpy as np

    from mpi4jax_tpu_torch.ops import _collectives, quantized
    from mpi4jax_tpu_torch.runtime import bridge, transport
    from mpi4jax_tpu_torch.topo import _ici_leg
    from mpi4jax_tpu_torch.utils.config import hier_mode, quant_mode

    from mpi4jax_tpu_torch import topo as _topo
    from mpi4jax_tpu_torch.tune import _joint, _model

    comm = transport.get_world_comm(device=args.device)
    n = comm.size()
    topology = _topo.get_topology(comm.handle)
    multi = topology is not None and topology.multi
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes
             else DEFAULT_SIZES)
    ops = [tune._check_op(o.strip()) for o in args.ops.split(",")
           if o.strip()]
    only = None
    if args.joint_combos:
        only = {c.strip() for c in args.joint_combos.split(",")
                if c.strip()}
    qm, hm = quant_mode(), hier_mode()
    # whether the intra-island leg takes f32 SUM hring/htree allreduces in
    # this process (the topology's eligibility under MPI4JAX_TPU_ICI_LEG)
    leg_on = bool(multi and _ici_leg.ici_leg_status(comm.handle)["active"])

    def _runs_as_labeled(combo, op):
        """Whether forcing this combo's algorithm per call runs the
        labeled schedule under this process's gates: the transport
        upgrades exact picks under a force gate, and a row timing the
        upgrade under an exact label would be noise dressed up as a
        measurement."""
        algo = _joint.combo_algo(combo)
        gates = _joint.combo_gates(combo)
        wants_ici = "MPI4JAX_TPU_ICI_LEG" in gates
        if wants_ici and not leg_on:
            # +ici exists only where the leg is on (the driver measures
            # these in their own gated sub-jobs)
            return False
        if op == "allreduce" and algo in tune.HIER_ALGOS \
                and leg_on and not wants_ici:
            # the leg takes every f32 SUM hring/htree call: a plain (or
            # +q) hierarchical row here would time the leg under the
            # wrong label
            return False
        if "MPI4JAX_TPU_COLL_QUANT" in gates:
            # +q exists only under the force gate (its own sub-job)
            return qm == "force"
        if qm == "force":
            if algo in ("ring", "rd", "tree"):
                return False  # upgraded to the quantized twin
            if algo in tune.HIER_ALGOS:
                return False  # leader leg quantized: that IS +q
            if algo == "halltoall":
                return False  # leader leg quantized: that IS hqalltoall
        if hm == "force" and multi and algo in ("ring", "rd", "tree"):
            return False  # upgraded to the hierarchical twin
        return True

    candidates = {}
    for op in ops:
        cands = _joint.eligible_combos(op, multi_island=multi,
                                       quant_mode=qm, hier_mode=hm,
                                       ici_leg=leg_on)
        cands = [c for c in cands if _runs_as_labeled(c, op)]
        if only is not None:
            cands = [c for c in cands if c in only]
        if cands:
            candidates[op] = cands

    seed = _model.load_model(args.joint_model) if args.joint_model else None

    def measure(op, nbytes, combo):
        algo = _joint.combo_algo(combo)
        repeats = args.repeats or max(7, min(30, int(3e6 / max(nbytes, 1))))
        return _time_point(comm, bridge, np, op, nbytes, algo, repeats)

    def log(row):
        if comm.rank() == 0:
            print(json.dumps(row), flush=True)

    _collectives.LAUNCHES["fused_ring"] = 0
    quantized.LAUNCHES["quant_pack"] = 0
    best, measurements, model = _joint.joint_search(
        measure, candidates, sizes, model=seed, topk=max(args.topk, 1),
        ranks=n, log=log)
    launched = bridge.allgather(comm.handle, np.array(
        [_collectives.LAUNCHES["fused_ring"],
         quantized.LAUNCHES["quant_pack"]], np.int64), n).sum(0)
    if comm.rank() == 0 and args.joint_out:
        payload = {
            "world_size": n,
            "multi": bool(multi),
            "topology": topology.fingerprint() if multi else None,
            "leg": leg_on,
            "measurements": measurements,
            "launches": {"fused_ring": int(launched[0]),
                         "quant_pack": int(launched[1])},
        }
        tmp = f"{args.joint_out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, args.joint_out)
    bridge.barrier(comm.handle)  # the results are on disk before any exit
    return 0


def _leg_takes_all(base, gates, combos) -> bool:
    """Whether a gated sub-job would measure nothing: where the base
    sub-job found the intra-island leg on, the leg takes every
    hierarchical f32 SUM call of a sub-job without the leg's gate, so
    ``_runs_as_labeled`` drops each of these combos.  The JAX driver
    launches such a sub-job all the same."""
    from mpi4jax_tpu_torch.tune import _joint

    return (bool(base.get("leg")) and "MPI4JAX_TPU_ICI_LEG" not in gates
            and all(_joint.combo_algo(c) in tune.HIER_ALGOS
                    for c in combos))


def _joint_driver(args) -> int:
    """The joint search: the base sub-job measures every combo a call can
    force; on a multi-island topology each gate set of the gated combos
    (the quantized leader leg, the intra-island leg on the card, both) gets
    a sub-job of its own; the merged winners become one v2 cache and the
    fitted cost-model file."""
    import tempfile

    from mpi4jax_tpu_torch.runtime import launch
    from mpi4jax_tpu_torch.tune import _joint, _model
    from mpi4jax_tpu_torch.utils import config

    np_ = args.np_ or 4
    workdir = tempfile.mkdtemp(prefix="m4j_joint_")

    def _sub_job(label, out_path, extra_env, extra_args, job_index=0):
        cmd = ["-n", str(np_)]
        if args.port:
            # a fresh port block per sub-job: the last job's sockets may
            # still sit in TIME_WAIT
            cmd += ["--port", str(args.port + job_index * (np_ + 2))]
        cmd += [os.path.abspath(__file__), "--joint", "--joint-out",
                out_path, "--topk", str(args.topk)]
        cmd += _sweep_args(args) + extra_args
        env = dict(os.environ)
        if not os.environ.get("MPI4JAX_TPU_FAKE_HOSTS", "").strip():
            env["MPI4JAX_TPU_DISABLE_SHM"] = "1"
        env.pop("MPI4JAX_TPU_COLL_ALGO", None)
        # an inherited force gate would upgrade the per-call forced exact
        # algorithms (ring -> qring/hring, ...) and mislabel every plain
        # row: the driver owns the gates (an operator's deny stays: it
        # narrows the candidates instead)
        for gate in ("MPI4JAX_TPU_COLL_QUANT", "MPI4JAX_TPU_HIER",
                     "MPI4JAX_TPU_ICI_LEG"):
            if env.get(gate, "").strip() == "force" \
                    and gate not in extra_env:
                print(f"tune: --joint: ignoring inherited {gate}=force "
                      "for the sweep sub-job (forced upgrades would "
                      "mislabel the exact-algorithm rows); gated "
                      "combinations are measured in their own sub-job",
                      file=sys.stderr, flush=True)
                env.pop(gate)
        env.update(extra_env)
        t0 = time.perf_counter()
        # the launcher runs here, in-process (the ranks inherit env): a
        # launcher process of its own would add an interpreter's start
        saved = dict(os.environ)
        os.environ.clear()
        os.environ.update(env)
        try:
            rc = launch.main(cmd)
        finally:
            os.environ.clear()
            os.environ.update(saved)
        secs = time.perf_counter() - t0
        if rc != 0:
            return rc, None
        try:
            with open(out_path) as f:
                result = json.load(f)
        except (OSError, ValueError) as e:
            print(f"tune: --joint: sub-job wrote no results: {e}",
                  file=sys.stderr, flush=True)
            return 2, None
        print(json.dumps({
            "sub_job": label, "gates": extra_env,
            "combos": sorted({r["combo"] for r in result["measurements"]}),
            "seconds": secs, "rows": len(result["measurements"]),
            "launches": result["launches"]}), flush=True)
        return 0, result

    seed_args = []
    if args.from_trace:
        # recordings seed the model: the ranks start from the real run's
        # medians (with --from-trace's world-generation gate)
        try:
            events, _size = tune.collect_trace_events(
                _trace_paths(args.from_trace))
            seed = tune.fit_model_from_events(events, world_size=np_,
                                              source="trace-seed")
            seed_path = os.path.join(workdir, "seed_model.json")
            _model.save_model(seed, path=seed_path)
            seed_args = ["--joint-model", seed_path]
        except (OSError, ValueError) as e:
            print(f"tune: --joint: cannot seed from recordings ({e}); "
                  "searching unseeded", file=sys.stderr, flush=True)

    rc, base = _sub_job("base", os.path.join(workdir, "base.json"), {},
                        seed_args)
    if rc != 0 or base is None:
        return rc or 2
    n = int(base["world_size"])
    topo_fp = base.get("topology")
    sets = [base["measurements"]]

    if base.get("multi"):
        # the gated combos exist only under their per-process force gates:
        # one sub-job per gate set, each measuring only the combos it
        # gates; an operator's deny/off drops the matching sets
        by_gates = {}
        for c in _joint.JOINT_CANDIDATES["allreduce"]:
            gates = _joint.combo_gates(c)
            if not gates:
                continue
            if "MPI4JAX_TPU_COLL_QUANT" in gates \
                    and config.quant_mode() == "deny":
                continue
            if "MPI4JAX_TPU_ICI_LEG" in gates \
                    and config.ici_leg_mode() == "off":
                continue
            by_gates.setdefault(tuple(sorted(gates.items())), []).append(c)
        for j, gk in enumerate(sorted(by_gates), start=1):
            combos = by_gates[gk]
            label = "+" + combos[0].split("+", 1)[1]  # "+q", "+ici", ...
            if _leg_takes_all(base, dict(gk), combos):
                print(json.dumps({
                    "sub_job": label, "gates": dict(gk), "combos": combos,
                    "skipped": "the intra-island leg takes these "
                               "schedules"}), flush=True)
                continue
            rc, gated = _sub_job(
                label, os.path.join(workdir, f"gated_{j}.json"), dict(gk),
                seed_args + ["--joint-combos", ",".join(combos)],
                job_index=j)
            if rc == 0 and gated is not None:
                sets.append(gated["measurements"])
            else:
                print(f"tune: --joint: the gated sub-job for "
                      f"{', '.join(combos)} failed; the cache is "
                      "written without those rows",
                      file=sys.stderr, flush=True)

    best, rows = _joint.merge_winners(sets)
    if not best:
        print("tune: --joint: no measurements survived; nothing to "
              "write", file=sys.stderr, flush=True)
        return 2
    model = _model.CostModel.from_measurements(
        rows, world_size=n, topology=topo_fp, source="joint",
        knobs=config.knob_env())
    model_file = _model.save_model(
        model, path=args.model_out or config.tune_model_path())
    cache = tune.cache_from_joint(n, best, rows, path=args.cache,
                                  topo_fingerprint=topo_fp,
                                  model_file=model_file)
    for op in sorted(best):
        for nbytes in sorted(best[op]):
            print(json.dumps({"op": op, "bytes": nbytes,
                              "winner": best[op][nbytes]}), flush=True)
    print(f"tune: joint cache written to {cache}")
    print(f"tune: cost model written to {model_file}")
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.from_trace and not args.joint:
        return _from_trace(args)
    from mpi4jax_tpu_torch.runtime import transport

    if args.joint:
        if transport.in_world():
            return _joint_rank(args)
        return _joint_driver(args)
    if transport.in_world():
        return _rank(args)
    return _outer(args)


if __name__ == "__main__":
    sys.exit(main())
