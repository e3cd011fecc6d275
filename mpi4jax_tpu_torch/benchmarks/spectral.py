"""Spectral Poisson solve (slab-decomposed 3-D FFT) of the PyTorch port.

The counterpart of ``bench_spectral`` in the repo's ``bench.py``: ms per
``models.spectral.poisson_solve`` of an ``--n``³ f32 field decomposed over
``--ranks`` ranks of a ``make_mesh`` comm on one card, after one warm-up
solve, over ``--solves`` timed solves of the same right-hand side (CUDA
events on the card).  The right-hand side is the manufactured one of the
JAX package's spectral test: u = sin x · cos 2y · sin z on [0, 2π)³ and
f = ∇²u = −6u, so every solve is checked against u.  Each solve launches
the alltoall kernel twice at ranks > 1 (once in ``fft3``, once in
``ifft3``) and never at ranks = 1.

    python -m mpi4jax_tpu_torch.benchmarks.spectral --n 256 --ranks 4 \\
        --solves 5 --json

The run prints one JSON line: ``ms_per_solve``, ``ranks``, ``n``,
``solves``, ``alltoall_launches_per_solve``, ``max_abs_err`` (against u)
and ``device`` (the card's name).  On the CPU (``--device cpu``) it runs the
plain versions and times them on the host clock; such a run measures
nothing of the card, and launches no kernel.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from ..models import spectral
from ..ops import _collectives
from ..parallel.mesh import make_mesh
from ._profile import kernel_ms_by_group


def manufactured(n: int, comm):
    """The f32 right-hand side f = −6u and the solution u, both in the
    comm's X-slab layout ``(size, n/size, n, n)``, made on its device in
    float64 and rounded once."""
    size = comm.size()
    if n % size:
        raise ValueError(f"n ({n}) must be divisible by the ranks ({size})")
    g = torch.arange(n, dtype=torch.float64, device=comm.device) * (
        2 * math.pi / n)
    u = (torch.sin(g)[:, None, None] * torch.cos(2 * g)[None, :, None]
         * torch.sin(g)[None, None, :])
    u = u.reshape(size, n // size, n, n)
    return (-6.0 * u).to(torch.float32), u.to(torch.float32)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n: int = 256, ranks: int = 4, solves: int = 5, *, device=None):
    """Time ``solves`` Poisson solves at ``n``³ over ``ranks`` ranks; returns
    the record and the last solution."""
    comm = make_mesh(ranks, device=device)
    dev = comm.device
    f, u_true = manufactured(n, comm)

    def solve():
        return spectral.poisson_solve(f, comm=comm, shape=(n, n, n))

    solve()  # warm-up: the kernel build, cuFFT plans
    _sync(dev)
    before = _collectives.LAUNCHES["alltoall"]
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(solves):
            u = solve()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / solves
        name = torch.cuda.get_device_name(dev)
    else:
        t0 = time.perf_counter()
        for _ in range(solves):
            u = solve()
        ms = (time.perf_counter() - t0) * 1e3 / solves
        name = str(dev)
    launches = _collectives.LAUNCHES["alltoall"] - before
    rec = {
        "metric": "spectral_poisson_ms_per_solve", "n": n, "ranks": ranks,
        "solves": solves, "ms_per_solve": ms,
        "alltoall_launches_per_solve": launches / solves,
        "max_abs_err": float((u - u_true).abs().max()), "device": name,
    }
    return rec, u


# the groups of a solve's kernels in ``device_profile``: the first label
# whose key occurs in the kernel's name
KERNEL_GROUPS = (
    ("alltoall_kernel", "alltoall kernel"),
    ("fft", "cuFFT"),
    ("direct_copy", "copies: the strided transposes, the cast"),
    ("MulFunctor<c10::complex<float>", "complex multiplies: ifft scaling, "
                                       "spectrum x 1/k2"),
)


def _group(name: str) -> str:
    for key, label in KERNEL_GROUPS:
        if key in name:
            return label
    return "wavenumber arithmetic (k2, where, 1/k2) and other"


def device_profile(n: int = 256, ranks: int = 4, solves: int = 3, *,
                   device=None):
    """Where a solve's time goes on the card: kernel time per solve by
    group (``KERNEL_GROUPS``; ``torch.profiler``, CUPTI) and the share of
    the host-timed window in which the card was busy, the profiler's own
    cost included.  Card only."""
    comm = make_mesh(ranks, device=device)
    f, _ = manufactured(n, comm)
    wall_ms, groups, _ = kernel_ms_by_group(
        lambda: spectral.poisson_solve(f, comm=comm, shape=(n, n, n)),
        solves, _group, comm.device)
    busy_ms = sum(groups.values())
    return {"ranks": ranks, "n": n, "wall_ms_per_solve": wall_ms,
            "busy_ms_per_solve": busy_ms, "busy_share": busy_ms / wall_ms,
            "ms_per_solve_by_group": groups}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)
    rec, _ = run(args.n, args.ranks, args.solves, device=args.device)
    if not args.json:
        print(f"{args.n}^3 Poisson solve over {args.ranks} ranks on "
              f"{rec['device']}: {rec['ms_per_solve']:.4f} ms per solve, "
              f"max |u - u_true| = {rec['max_abs_err']:.3e}")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
