"""Path (o): plan execution's overlap, with the plan off and on.

The counterpart of ``benchmarks/schedule_overlap.py``, on tensors: the
payloads live on ``--device`` and go through the world ops ``mt.send`` and
``mt.recv``, so the staged ops consult the plan runner
(``runtime/planrt.py``) as a program's do.

1. **the chain pipeline**: rank r sends a block to r + 1, computes (an idle
   host window, ``time.sleep``, the shape of a host waiting on its card),
   and receives a block from r - 1, ``--rounds`` times.  With the plan off
   a send of a block past the socket's buffering waits until the next rank
   reaches its receive; with it on (``_pipeline_schedule`` compiled,
   proved and installed), the send posts as a deferred ticket and the
   receive is pre-posted at the send's post point, so the progress thread
   moves the wire during the window.  Every received block is held to its
   numpy oracle, and each rank's digest of the received bytes must be the
   same with the plan on and off.
2. **bucketed allreduce**: ``--grads`` gradients of ``--grad-kb`` KB as
   one allreduce each, then fused into buckets of ``--bucket-kb`` KB
   (``MPI4JAX_TPU_PLAN_BUCKET_KB``'s meaning); the sums must agree.

Run under the launcher; rank 0 prints one ``obs.bench_record`` row per
configuration and, last, one JSON line with the runner's counts summed over
the ranks (``hoisted_recvs``, ``deferred_sends``, ``mismatches``).  The
chain's time per round is its slowest rank's, each rank timed from the
first send through the runner's flush of its last deferred sends; the line
also gives every rank's time and the share inside its sends, receives and
flush:

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 \\
        -m mpi4jax_tpu_torch.benchmarks.schedule_overlap [-- --device cpu]

The defaults are the JAX benchmark's: 15 rounds of 4096 KB f32 blocks, a
3 ms window, 64 gradients of 8 KB in 512 KB buckets.  One untimed round
of the chain, plan off, warms every rank first.  Posts run the same
op bodies as the blocking entries, so on one host they ride the shm ring
where it is on; the JAX plan tests run with ``MPI4JAX_TPU_DISABLE_SHM=1``
(TCP), and so does ``chip_smoke.py``'s phase 33.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file by the launcher's ranks
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402


def _pipeline_schedule(n, rounds, shape):
    """Chain: rank r sends to r + 1 (r < n - 1) and receives from r - 1
    (r > 0), ``rounds`` times (``benchmarks/schedule_overlap.py:88-105``
    of the JAX package)."""
    from mpi4jax_tpu_torch.analysis import _events

    events = {}
    for rank in range(n):
        evs = []
        for k in range(rounds):
            if rank < n - 1:
                evs.append(_events.CommEvent(rank, len(evs), "send",
                                             dest=rank + 1, tag=k,
                                             dtype="float32", shape=shape))
            if rank > 0:
                evs.append(_events.CommEvent(rank, len(evs), "recv",
                                             source=rank - 1, tag=k,
                                             dtype="float32", shape=shape))
        events[rank] = evs
    return events, {(0,): tuple(range(n))}


def block_oracle(count: int, rank: int, k: int) -> np.ndarray:
    """The block rank ``rank`` sends in round ``k``."""
    return np.arange(count, dtype=np.float32) + np.float32(1000 * rank + k)


#: the per-rank seconds ``bench_pipeline`` returns, in gather order
PARTS = ("total", "send", "recv", "flush")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_pipeline(comm, rounds, shape, compute_s, use_plan):
    """``(parts, digest, stats)``: this rank's seconds (``total``, the chain
    through the runner's flush of its last deferred sends; ``send``,
    ``recv`` and ``flush``, the time inside those calls), its digest of the
    received blocks (each held to its oracle) and the runner's counts
    (zeros with the plan off)."""
    import torch

    import mpi4jax_tpu_torch as mt
    from mpi4jax_tpu_torch.analysis import _plan
    from mpi4jax_tpu_torch.runtime import planrt

    dev = comm.device
    rank, n = comm.rank(), comm.size()
    count = int(np.prod(shape))
    blocks = [torch.from_numpy(block_oracle(count, rank, k)).to(dev)
              for k in range(rounds)] if rank < n - 1 else []
    _sync(dev)
    mt.barrier(comm=comm)  # before the runner: the plan has no barrier
    rt = None
    if use_plan:
        events, comms = _pipeline_schedule(n, rounds, shape)
        plan = _plan.compile_schedules(events, comms)
        if not (plan.proved and plan.rewritten):
            raise AssertionError(f"the chain's plan: {plan.reasons}")
        if not planrt.install(comm.handle, plan, rank,
                              pin_memory=dev.type == "cuda"):
            raise AssertionError("planrt.install refused the chain's plan")
        rt = planrt.get(comm)
    got = []
    parts = dict.fromkeys(PARTS, 0.0)
    t0 = time.perf_counter()
    for k in range(rounds):
        if rank < n - 1:
            t = time.perf_counter()
            mt.send(blocks[k], dest=rank + 1, tag=k, comm=comm)
            parts["send"] += time.perf_counter() - t
        time.sleep(compute_s)
        if rank > 0:
            t = time.perf_counter()
            got.append(mt.recv(torch.empty(shape, dtype=torch.float32,
                                           device=dev),
                               source=rank - 1, tag=k, comm=comm))
            parts["recv"] += time.perf_counter() - t
    if rt is not None:
        t = time.perf_counter()
        rt.flush()  # the last deferred sends are part of the chain's work
        parts["flush"] = time.perf_counter() - t
    _sync(dev)
    parts["total"] = time.perf_counter() - t0
    stats = {"hoisted_recvs": 0, "deferred_sends": 0, "mismatches": 0}
    if rt is not None:
        planrt.detach(comm.handle)
        stats = dict(rt.stats)
    mt.barrier(comm=comm)
    digest = hashlib.sha256()
    for k, g in enumerate(got):
        host = g.cpu().numpy()
        want = block_oracle(count, rank - 1, k)
        if not np.array_equal(host, want):
            raise AssertionError(f"rank {rank} round {k}: the received "
                                 "block differs from its oracle")
        digest.update(host.tobytes())
    return parts, digest.hexdigest(), stats


def bench_bucketed_allreduce(comm, n_grads, grad_elems, bucket_elems):
    """Per-leaf and bucketed gradient allreduce of the same bytes:
    ``(per_leaf_s, bucketed_s, n_buckets)``; the two sums must agree."""
    import torch

    import mpi4jax_tpu_torch as mt

    dev = comm.device
    grads = [torch.full((grad_elems,), float(comm.rank() + 1 + i % 7),
                        dtype=torch.float32, device=dev)
             for i in range(n_grads)]
    mt.barrier(comm=comm)
    _sync(dev)
    t0 = time.perf_counter()
    leaf = [mt.allreduce(g, comm=comm) for g in grads]
    _sync(dev)
    per_leaf = time.perf_counter() - t0
    per_bucket = max(1, bucket_elems // grad_elems)
    mt.barrier(comm=comm)
    _sync(dev)
    t0 = time.perf_counter()
    buckets = [mt.allreduce(torch.cat(grads[i:i + per_bucket]), comm=comm)
               for i in range(0, n_grads, per_bucket)]
    _sync(dev)
    bucketed = time.perf_counter() - t0
    if not torch.equal(torch.cat(leaf), torch.cat(buckets)):
        raise AssertionError("bucketed and per-leaf sums differ")
    return per_leaf, bucketed, len(buckets)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--block-kb", type=int, default=4096,
                    help="pipeline block per message (KB): past the "
                         "socket's buffering the blocking send waits for "
                         "the receiver, which the plan's overlap hides")
    ap.add_argument("--compute-ms", type=float, default=3.0,
                    help="the idle window between a send and a receive")
    ap.add_argument("--grads", type=int, default=64)
    ap.add_argument("--grad-kb", type=int, default=8)
    ap.add_argument("--bucket-kb", type=int, default=512)
    args = ap.parse_args(argv)

    import torch

    from mpi4jax_tpu_torch import obs
    from mpi4jax_tpu_torch.runtime import bridge, transport

    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    comm = transport.get_world_comm(device=args.device)
    rank, n = comm.rank(), comm.size()
    if n < 2:
        raise SystemExit("run at np >= 2")
    shape = (args.block_kb * 256,)  # KB -> f32 elements
    # one untimed round first: the card's context on every rank (the last
    # rank makes no tensor before its first receive), the transport's
    # connections and the pinned staging blocks
    bench_pipeline(comm, 1, shape, 0.0, False)
    rows, digests, stats, by_rank = [], {}, {}, {}
    for use_plan, label in ((False, "off"), (True, "on")):
        parts, digests[label], stats[label] = bench_pipeline(
            comm, args.rounds, shape, args.compute_ms / 1e3, use_plan)
        # every rank's seconds: the chain is as slow as its slowest rank
        by_rank[label] = bridge.allgather(
            comm.handle, np.array([parts[k] for k in PARTS], np.float64), n)
        rows.append(obs.bench_record(
            op="plan_pipeline", nbytes=args.block_kb * 1024,
            seconds=float(by_rank[label][:, 0].max()) / args.rounds,
            ranks=n, tier="plan", reps=args.rounds, plan=label,
            compute_ms=args.compute_ms, compute_kind="idle",
            device=str(comm.device)))
    if digests["on"] != digests["off"]:
        raise AssertionError(f"rank {rank}: the received bytes differ with "
                             "the plan on and off")
    per_leaf, bucketed, n_buckets = bench_bucketed_allreduce(
        comm, args.grads, args.grad_kb * 256, args.bucket_kb * 256)
    keys = ("hoisted_recvs", "deferred_sends", "mismatches")
    counts = bridge.allgather(
        comm.handle, np.array([stats["on"][k] for k in keys], np.int64), n)
    comm.finalize()
    if rank != 0:
        return 0
    total = args.grads * args.grad_kb * 1024
    rows.append(obs.bench_record(
        op="plan_bucketed_allreduce", nbytes=total, seconds=per_leaf,
        ranks=n, tier="plan", plan="off", n_allreduce=args.grads))
    rows.append(obs.bench_record(
        op="plan_bucketed_allreduce", nbytes=total, seconds=bucketed,
        ranks=n, tier="plan", plan="on", n_allreduce=n_buckets))
    for row in rows:
        print(json.dumps(row), flush=True)
    pipe = {r["plan"]: r for r in rows if r["op"] == "plan_pipeline"}
    summary = {
        "schedule_overlap": True, "ranks": n, "device": str(comm.device),
        "rounds": args.rounds, "block_bytes": args.block_kb * 1024,
        "compute_ms": args.compute_ms,
        "us_per_round_off": pipe["off"]["seconds"] * 1e6,
        "us_per_round_on": pipe["on"]["seconds"] * 1e6,
        # per rank, per round: the chain through the flush, and the time
        # inside send, recv and the flush
        "us_per_round_by_rank": {
            label: {k: (by_rank[label][:, i] / args.rounds * 1e6).tolist()
                    for i, k in enumerate(PARTS)}
            for label in ("off", "on")},
        "per_leaf_s": per_leaf, "bucketed_s": bucketed,
        "n_allreduce_per_leaf": args.grads, "n_buckets": n_buckets,
        "runner": {k: int(counts[:, i].sum()) for i, k in enumerate(keys)},
        "runner_by_rank": counts.tolist(), "digests_equal": True,
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
