"""The world-tier shallow-water solver, one process per rank: path (k).

The counterpart of ``benchmarks/sw_world_rank.py``: the reference's
``mpirun -n N python examples/shallow_water.py --benchmark`` shape, each
rank running ``WorldShallowWater`` on its block with its halos on
``neighbor_exchange``.  Launch::

    python -m mpi4jax_tpu_torch.runtime.launch -n 4 \\
        -m mpi4jax_tpu_torch.benchmarks.sw_world -- --grid 2 2 --json

- **What it times.**  The steps after the first (Euler) step, behind a
  warm-up of ``WARMUP`` steps, with each rank's stream synchronized before
  and after (the JAX package's timed region); the seconds are the slowest
  rank's.  At ``--days 0.1`` they are the s per 0.1 model day.
- **The halo share.**  ``HALO_STEPS`` more steps, timed one by one, in
  which each ``neighbor_exchange`` (the staging to and from pinned memory
  and the transport) is timed on the host between two synchronizations of
  the stream: the median over those steps of the halo time over the step
  time; rank 0's, and the largest of any rank.  The synchronizations slow
  the step, so the share is one of an instrumented step.
- **Under the static verifier** (``python -m mpi4jax_tpu_torch.analyze -m
  mpi4jax_tpu_torch.benchmarks.sw_world --np 4 -- --grid 2 2``) the same
  program runs in the virtual world: every exchange is recorded, and the
  timings are the virtual world's.
- **What it writes.**  Rank 0 prints one line (``--json``: the record as
  JSON) and, with ``--check-out PATH``, saves the gathered ``h``, ``u`` and
  ``v`` and the record to that ``.npz``.  h must stay finite.

``run_job`` launches the ranks through the launcher in-process, runs one
or more grids on sub-communicators of the first ``gy * gx`` ranks, and
returns each grid's record and gathered fields.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

if __package__ in (None, ""):  # run as a file by the launcher's ranks
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

WARMUP = 3
HALO_STEPS = 20


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _halo_share(model, state, steps, dev):
    """Per step, the host seconds inside the halo exchanges (each between
    two synchronizations of the stream) and the step's seconds, over
    ``steps`` steps timed one by one: the medians of the halo time, of the
    step time and of their ratio (a rare slow step does not move them)."""
    orig = model._dir_exchange
    spent = [0.0]

    def timed(*args):
        _sync(dev)
        t0 = time.perf_counter()
        out = orig(*args)
        _sync(dev)
        spent[0] += time.perf_counter() - t0
        return out

    model._dir_exchange = timed
    one = model.step_fn(1)
    halos, totals = [], []
    try:
        for _ in range(steps):
            spent[0] = 0.0
            _sync(dev)
            t0 = time.perf_counter()
            state = one(state)
            _sync(dev)
            totals.append(time.perf_counter() - t0)
            halos.append(spent[0])
    finally:
        del model._dir_exchange
    return (statistics.median(halos), statistics.median(totals),
            statistics.median(h / t for h, t in zip(halos, totals)))


def run_grid(comm, grid, size, days, check_out=None) -> dict:
    """Path (k) on ``comm``'s ``gy * gx`` ranks; returns rank 0's record
    (None elsewhere) and saves the gathered fields to ``check_out``."""
    import torch

    import mpi4jax_tpu_torch as mt
    from mpi4jax_tpu_torch.models.shallow_water import SWParams
    from mpi4jax_tpu_torch.models.shallow_water_world import \
        WorldShallowWater

    t_start = time.perf_counter()
    dev = comm.device
    n = comm.size()
    params = SWParams(dx=5e3, dy=5e3)
    model = WorldShallowWater(comm, grid, tuple(size), params)
    n_steps = int(days * params.day_seconds / params.dt)

    s0 = model.init()
    state = model.step_fn(1, first=True)(s0)
    run = model.step_fn(n_steps - 1)
    model.step_fn(WARMUP)(state)  # warm-up: allocator, pinned blocks
    _sync(dev)
    mt.barrier(comm=comm)
    ex0 = model.exchanges
    t0 = time.perf_counter()
    out = run(state)
    _sync(dev)
    mine = time.perf_counter() - t0
    exchanges = (model.exchanges - ex0) / max(n_steps - 1, 1)
    seconds = float(mt.allgather(
        torch.tensor([mine], dtype=torch.float64, device=dev),
        comm=comm).max())
    if not bool(torch.isfinite(out.h).all()):
        raise AssertionError(f"rank {comm.rank()}: h is not finite")
    halo = _halo_share(model, out, HALO_STEPS, dev)
    shares = mt.allgather(
        torch.tensor([halo[2]], dtype=torch.float64, device=dev),
        comm=comm)[:, 0].cpu().numpy()
    m0, m1 = model.total_mass(s0), model.total_mass(out)
    fields = {k: model.gather_global(getattr(out, k)) for k in "huv"}
    rec = None
    if comm.rank() == 0:
        timed = n_steps - 1
        rec = {"bench": "sw_world", "ranks": n, "grid": list(grid),
               "size": list(size), "days": days, "device": str(dev),
               "steps": timed, "seconds": seconds,
               "ms_per_step": seconds / timed * 1e3,
               "exchanges_per_step": exchanges,
               "neighbor_exchanges_per_step": 2 * exchanges,
               "halo_steps": HALO_STEPS,
               "halo_ms_per_step": halo[0] * 1e3,
               "instrumented_ms_per_step": halo[1] * 1e3,
               "halo_share": float(shares[0]),
               "halo_share_max": float(shares.max()),
               "mass_drift": abs(m1 - m0) / abs(m0),
               "h_range": [float(fields["h"].min()),
                           float(fields["h"].max())],
               "rank_seconds": time.perf_counter() - t_start}
        if check_out:
            np.savez(check_out, record=np.array(json.dumps(rec)), **fields)
    mt.barrier(comm=comm)
    if model.grid._col_comm is not None:
        model.grid._col_comm.finalize()
    return rec


def _world(device):
    import torch

    from mpi4jax_tpu_torch.runtime import transport

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    return transport.get_world_comm(device=dev)


def _job(spec) -> None:
    """The ranks' side of ``run_job``: each run on the first ``gy * gx``
    ranks (a sub-communicator), one after the other."""
    import mpi4jax_tpu_torch as mt

    world = _world(spec["device"])
    for i, (grid, size) in enumerate(spec["runs"]):
        need = grid[0] * grid[1]
        sub = world.split(color=0 if world.rank() < need else -1,
                          key=world.rank())
        if sub is not None:
            run_grid(sub, tuple(grid), tuple(size), spec["days"],
                     os.path.join(spec["out"], f"run{i}.npz"))
            sub.finalize()
    mt.barrier(comm=world)
    world.finalize()


def run_job(runs, out_dir, *, days=0.1, device="cuda",
            timeout=900.0) -> dict:
    """Launch the ranks of this program through the port's launcher
    in-process, as many as the largest grid of ``runs`` (``[(grid, size),
    ...]``), and run each grid on a sub-communicator of the first ``gy *
    gx`` ranks, one after the other; returns ``{grid: (record, {"h", "u",
    "v": arrays})}``.  A failed rank raises."""
    from mpi4jax_tpu_torch.runtime import launch

    runs = [(tuple(g), tuple(s)) for g, s in runs]
    spec = {"runs": runs, "days": days, "device": str(device),
            "out": out_dir}
    path = os.path.join(out_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    ranks = max(g[0] * g[1] for g, _ in runs)
    rc = launch.main(["-n", str(ranks), "--timeout", str(timeout),
                      os.path.abspath(__file__), "--job", path])
    if rc != 0:
        raise RuntimeError(f"sw_world job {runs} failed: the launcher "
                           f"exited {rc}")
    out = {}
    for i, (grid, _) in enumerate(runs):
        with np.load(os.path.join(out_dir, f"run{i}.npz")) as z:
            out[grid] = (json.loads(str(z["record"])),
                         {k: z[k] for k in "huv"})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--job", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--grid", type=int, nargs=2, default=None,
                    help="(gy gx); default 1 x ranks")
    ap.add_argument("--size", type=int, nargs=2, default=(1800, 3600))
    ap.add_argument("--days", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check-out", default=None, metavar="PATH",
                    help="rank 0 saves the gathered h, u, v here (.npz)")
    ap.add_argument("--json", action="store_true",
                    help="print the record as one JSON line")
    args = ap.parse_args(argv)
    if args.job:
        with open(args.job) as f:
            _job(json.load(f))
        return 0
    world = _world(args.device)
    grid = tuple(args.grid) if args.grid else (1, world.size())
    rec = run_grid(world, grid, args.size, args.days, args.check_out)
    world.finalize()
    if rec is not None:
        print(json.dumps(rec) if args.json else
              f"sw_world: {rec['steps']} steps on grid {rec['grid']} in "
              f"{rec['seconds']:.4f} s ({rec['ms_per_step']:.4f} ms/step), "
              f"halo share {rec['halo_share']:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
