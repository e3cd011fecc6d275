"""Offline collective autotuner CLI.

    python -m mpi4jax_tpu_torch.tune [--np 4] [--sizes 1024,...,16777216]
                                     [--repeats N] [--ops allreduce,alltoall]
                                     [--cache PATH] [--port P] [--device D]
    python -m mpi4jax_tpu_torch.tune --from-trace out.json.rank0.json[,...]

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
the topology's tiers and so the cache's topology fingerprint.  ``--joint``
(the joint algorithm x quantization x topology search) is not ported.
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
                    help="the joint search (not ported)")
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
    cmd += [os.path.abspath(__file__), "--device", args.device]
    for flag, val in (("--sizes", args.sizes),
                      ("--repeats", args.repeats or None),
                      ("--ops", args.ops)):
        if val:
            cmd += [flag, str(val)]
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


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.joint:
        raise NotImplementedError(
            "tune --joint (the joint search and its cost model, "
            "tune/_model.py and tune/_joint.py) is not ported; see "
            "ROADMAP.md §1 item 6")
    if args.from_trace:
        return _from_trace(args)
    from mpi4jax_tpu_torch.runtime import transport

    if transport.in_world():
        return _rank(args)
    return _outer(args)


if __name__ == "__main__":
    sys.exit(main())
