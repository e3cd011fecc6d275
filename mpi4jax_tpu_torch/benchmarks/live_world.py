"""Path (p): live re-tuning moves a world job's allreduce onto the leg.

The world program of ``tests/world/test_live_world.py:30-59`` at path
(g)'s size: 4 ranks on ``--fake-hosts 'r0,r1|r2,r3'``, one process each,
``--calls`` f32 SUM allreduces of ``--mib`` MiB a rank through
``ops.allreduce`` (``algo=None``: the installed table decides), each behind
a barrier.  Each rank pins its offline table to ``ring`` for allreduce
through a tune cache (as ``benchmarks/live_retune_bench.py`` pins its
static pick), and under ``--live`` rank 0 calls ``live.propose({"allreduce":
[(0, "hring")]})`` after call ``--propose-after``: the epoch rendezvous
installs ``hring`` on every rank at one boundary, and from there the
intra-island leg (``topo/_ici_leg.py``) takes the calls, with kernel 3
folding each island on the card.

Every call is held on every rank, bit for bit, to the simulator of the
schedule that ran (``topo/_simulate.py``): ``simulate_ring_sum`` before the
commit, ``simulate_hring_sum(intra="ring")`` (the leg's) after it; the
schedule a call ran is the table's at its dispatch, whose epoch the rank
reads after the call (the commit happens at a collective's top, before its
dispatch).  The launches of kernel 3 are counted per call.  The inputs
alternate between two seeded sets, so a stale result cannot pass.

The rank program sets, before its transport loads: the tune cache,
``MPI4JAX_TPU_DISABLE_SHM=1`` (the installed table dispatches, as in the
JAX test), ``MPI4JAX_TPU_LIVE_COOLDOWN_OPS=8`` (a rendezvous every 2
boundaries), ``MPI4JAX_TPU_LIVE_WINDOW=4096`` (the controller's self-fit
needs half a window of events, which 30 calls never reach, so the only
proposal is rank 0's) and ``MPI4JAX_TPU_ICI_LEG`` (``auto`` on the card,
where the ranks' tiers are ``ici``; ``force`` on the CPU, where the leg
runs its plain versions).  A knob already set wins.

    python -m mpi4jax_tpu_torch.runtime.launch -n 4 \\
        --fake-hosts 'r0,r1|r2,r3' --live \\
        -m mpi4jax_tpu_torch.benchmarks.live_world [-- --device cpu]

Rank 0 prints one JSON line (or writes it to ``--out``): every rank's
epoch, swaps, commit boundary and kernel-3 launches, the schedule, ms and
rank 0's kernel-3 launches of every call.  ``run_job`` launches
it in-process and returns that record.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

if __package__ in (None, ""):  # run as a file by the launcher's ranks
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

FAKE_HOSTS = "r0,r1|r2,r3"
RANKS = 4
CALLS = 30
PROPOSE_AFTER = 10
MIB = 16
SEED = 0


def inputs(seed: int, count: int, size: int) -> np.ndarray:
    """Every rank's f32 input ``(size, count)`` from ``seed``."""
    return (np.random.RandomState(seed).randn(size, count)
            .astype(np.float32) * 2)


def _pin_ring_cache(size: int) -> str:
    """A tune cache whose allreduce table is ``ring`` at every size."""
    from mpi4jax_tpu_torch import tune

    path = os.path.join(tempfile.mkdtemp(prefix="live_world_"),
                        f"tune_{size}.json")
    tune.save_cache(size, {"allreduce": [(0, "ring")]}, path=path)
    return path


def run_rank(device: str, calls: int, propose_after: int, mib: int,
             seed: int) -> dict:
    from mpi4jax_tpu_torch.runtime import transport

    rank_size = transport._detect_rank_size()
    if rank_size is None:
        raise SystemExit("run under the launcher: python -m "
                         "mpi4jax_tpu_torch.runtime.launch -n 4 "
                         f"--fake-hosts '{FAKE_HOSTS}' [--live] -m "
                         "mpi4jax_tpu_torch.benchmarks.live_world")
    on_cuda = device.startswith("cuda")
    own_cache = "MPI4JAX_TPU_TUNE_CACHE" not in os.environ
    if own_cache:
        os.environ["MPI4JAX_TPU_TUNE_CACHE"] = _pin_ring_cache(rank_size[1])
    os.environ.setdefault("MPI4JAX_TPU_DISABLE_SHM", "1")
    os.environ.setdefault("MPI4JAX_TPU_LIVE_COOLDOWN_OPS", "8")
    os.environ.setdefault("MPI4JAX_TPU_LIVE_WINDOW", "4096")
    os.environ.setdefault("MPI4JAX_TPU_ICI_LEG",
                          "auto" if on_cuda else "force")

    import torch

    from mpi4jax_tpu_torch import live, ops, topo
    from mpi4jax_tpu_torch.ops import _collectives
    from mpi4jax_tpu_torch.runtime import bridge
    from mpi4jax_tpu_torch.topo import _simulate as sim

    if not on_cuda:
        torch.set_num_threads(1)  # four ranks share the host's cores
    comm = transport.get_world_comm(device=device)
    dev = comm.device
    h = comm.handle
    rank, n = comm.rank(), comm.size()
    t = comm.topology()
    if t is None or not t.multi:
        raise AssertionError(f"rank {rank}: no multi-island topology "
                             f"(run with --fake-hosts '{FAKE_HOSTS}')")
    armed = live.armed()
    if not armed and bridge._live_boundary is not None:
        raise AssertionError("live is off, yet a boundary hook is installed")
    count = mib * 1024 * 1024 // 4
    sets = [inputs(seed + i, count, n) for i in range(2)]
    mine = [torch.from_numpy(s[rank].copy()).to(dev) for s in sets]
    want = {}  # (set, schedule) -> the simulator's result

    def expected(i, schedule):
        if (i, schedule) not in want:
            parts = list(sets[i])
            want[(i, schedule)] = (
                sim.simulate_ring_sum(parts) if schedule == "ring"
                else topo.simulate_hring_sum(parts, t.islands,
                                             intra="ring"))
        return want[(i, schedule)]

    def epoch():
        return live.status().get("epoch", 0) if live.armed() else 0

    rows = []
    for step in range(calls):
        i = step % 2
        ops.barrier(comm=comm)
        before = _collectives.LAUNCHES["fused_ring"]
        t0 = time.perf_counter()
        out = ops.allreduce(mine[i], comm=comm)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launched = _collectives.LAUNCHES["fused_ring"] - before
        ep = epoch()
        schedule = "hring" if ep >= 1 else "ring"
        got = out.cpu().numpy()
        if not np.array_equal(got.view(np.uint32),
                              expected(i, schedule).view(np.uint32)):
            raise AssertionError(
                f"rank {rank} call {step}: not bit for bit the {schedule} "
                "simulator")
        # the leg folds an island of two or more members with kernel 3
        leg = schedule == "hring" and dev.type == "cuda" \
            and len(t.island(rank)) > 1
        if launched != int(leg):
            raise AssertionError(f"rank {rank} call {step} ({schedule}): "
                                 f"kernel 3 launched {launched} times")
        rows.append({"call": step, "epoch": ep, "schedule": schedule,
                     "ms": ms, "launches": launched})
        if step == propose_after - 1 and rank == 0 and armed:
            live.propose({"allreduce": [(0, "hring")]}, note="path (p)")
    st = live.status()
    swaps = st.get("swaps", [])
    mine_row = [st.get("epoch", 0), len(swaps),
                swaps[0]["boundary"] if swaps else -1,
                int(bridge._live_boundary is not None),
                sum(r["launches"] for r in rows)]
    every = bridge.allgather(h, np.array(mine_row, np.int64), n)
    ms_all = bridge.allgather(h, np.array([r["ms"] for r in rows]), n)
    comm.finalize()
    if bridge._live_boundary is not None:
        raise AssertionError("the boundary hook outlived comm_finalize")
    if own_cache:
        import shutil

        shutil.rmtree(os.path.dirname(os.environ["MPI4JAX_TPU_TUNE_CACHE"]),
                      ignore_errors=True)
    slowest = ms_all.max(axis=0)
    commit = next((r["call"] for r in rows if r["schedule"] == "hring"),
                  None)

    def median(lo, hi):
        vals = slowest[lo:hi]
        return float(statistics.median(vals)) if len(vals) else None

    return {
        "rank": rank, "ranks": n, "device": str(dev), "live": armed,
        "islands": t.islands, "tiers": t.tiers, "bytes": count * 4,
        "calls": calls, "propose_after": propose_after,
        "epochs": every[:, 0].tolist(), "swaps": every[:, 1].tolist(),
        "commit_boundaries": every[:, 2].tolist(),
        "hooks_installed": every[:, 3].tolist(),
        "launches_by_rank": every[:, 4].tolist(),
        "commit_call": commit,
        "schedules": [r["schedule"] for r in rows],
        "launches": [r["launches"] for r in rows],
        "ms_slowest_rank": slowest.tolist(),
        # the steady state: the first call warms up, the proposal's
        # call and the commit's are left out
        "ms_before": median(1, propose_after),
        "ms_after": median(commit + 1, calls) if commit is not None
        else None,
        "period": max(1, int(os.environ["MPI4JAX_TPU_LIVE_COOLDOWN_OPS"])
                      // 4),
    }


def run_job(*, live: bool, device="cuda", calls=CALLS,
            propose_after=PROPOSE_AFTER, mib=MIB, seed=SEED,
            timeout=600.0) -> dict:
    """Launch the ``RANKS``-rank job on ``FAKE_HOSTS`` (with ``--live`` or
    not) through the port's launcher in-process; rank 0's record.  A failed
    rank or check raises."""
    from mpi4jax_tpu_torch.runtime import launch

    with tempfile.TemporaryDirectory(prefix="live_world_") as tmp:
        out = os.path.join(tmp, "record.json")
        argv = ["-n", str(RANKS), "--fake-hosts", FAKE_HOSTS,
                "--timeout", str(timeout)]
        if live:
            argv.append("--live")
        rc = launch.main(argv + [
            "-m", "mpi4jax_tpu_torch.benchmarks.live_world", "--",
            "--device", str(device), "--calls", str(calls),
            "--propose-after", str(propose_after), "--mib", str(mib),
            "--seed", str(seed), "--out", out])
        if rc != 0:
            raise RuntimeError(f"path (p) job (live={live}) failed: the "
                               f"launcher exited {rc}")
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--calls", type=int, default=CALLS)
    ap.add_argument("--propose-after", type=int, default=PROPOSE_AFTER)
    ap.add_argument("--mib", type=int, default=MIB,
                    help="MiB of f32 a rank per allreduce")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--out", default=None,
                    help="rank 0 writes its record here instead of "
                         "printing it")
    args = ap.parse_args(argv)
    rec = run_rank(args.device, args.calls, args.propose_after, args.mib,
                   args.seed)
    if rec["rank"] == 0:
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rec, f)
        else:
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
