"""Mesh allreduce (SUM, f32) message sweep of the PyTorch port.

The counterpart of the mesh part of the repo's ``benchmarks/allreduce_sweep.py``:
``ops.allreduce`` over a ``make_mesh(n)`` comm on one card, for message
sizes from ``--min-bytes`` per rank up to ``--max-bytes``, four times larger
at each step.  Each size prints one JSON line: ``op``, ``bytes`` (per
rank), ``seconds`` and ``us`` (median over ``--reps`` timed calls, CUDA
events around each, after ``--warmup`` calls), ``ranks``, the ``arm`` the
dispatch took (``butterfly``, ``hop_rs_ag`` or ``fused_ring``), and
``eff_GBps_per_chip`` = 2(n-1)/n · bytes / seconds (the bus-bandwidth
convention of the JAX package's ``obs`` bench records).

    python -m mpi4jax_tpu_torch.benchmarks.allreduce_sweep --ranks 4 \\
        --max-bytes 67108864

The inputs come from ``--seed``.  On the CPU (``--device cpu``) the sweep
runs the plain versions and times them on the host clock; such a run
measures nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from .. import ops
from ..ops import _collectives
from ..parallel.mesh import make_mesh


def sizes(min_bytes: int, max_bytes: int):
    """Per-rank message sizes, ×4 per step."""
    out, b = [], min_bytes
    while b <= max_bytes:
        out.append(b)
        b *= 4
    return out


def make_input(n: int, nbytes: int, seed: int, device) -> torch.Tensor:
    """The f32 input ``(n, nbytes // 4)`` of one size, from ``seed``."""
    g = torch.Generator(device="cpu").manual_seed(seed + nbytes)
    x = torch.randn(n, nbytes // 4, generator=g, dtype=torch.float32)
    return x.to(device)


def time_call(fn, device, warmup: int, reps: int) -> float:
    """Median seconds of ``fn()``: CUDA events on the card, the host clock
    on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def record(n: int, nbytes: int, seconds: float) -> dict:
    return {
        "op": "allreduce", "bytes": nbytes, "seconds": seconds,
        "us": seconds * 1e6, "ranks": n,
        "arm": _collectives.allreduce_arm(nbytes // 4, n),
        "eff_GBps_per_chip": 2 * (n - 1) / n * nbytes / seconds / 1e9,
    }


def sweep(n: int, min_bytes: int, max_bytes: int, *, device=None,
          seed: int = 0, warmup: int = 3, reps: int = 10, emit=None):
    """Time ``ops.allreduce`` at every size; returns the records and calls
    ``emit(record)`` for each as it is made."""
    comm = make_mesh(n, device=device)
    out = []
    for nbytes in sizes(min_bytes, max_bytes):
        x = make_input(n, nbytes, seed, comm.device)
        secs = time_call(lambda: ops.allreduce(x, op=ops.SUM, comm=comm),
                         comm.device, warmup, reps)
        rec = record(n, nbytes, secs)
        out.append(rec)
        if emit is not None:
            emit(rec)
        del x
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--min-bytes", type=int, default=1024)
    ap.add_argument("--max-bytes", type=int, default=64 * 1024 * 1024)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    return sweep(args.ranks, args.min_bytes, args.max_bytes,
                 device=args.device, seed=args.seed, warmup=args.warmup,
                 reps=args.reps, emit=lambda r: print(json.dumps(r),
                                                      flush=True))


if __name__ == "__main__":
    main()
