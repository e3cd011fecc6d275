"""The host's share of a hop: ``ring_shift2`` of path (a)'s y strips (the
2x2 grid at 1800x3600, 4 fields of nxl+2 f32 per rank and direction) on
the card, traced with cProfile.  The hop's call time, device time and
yardsticks are ``chip_smoke.py``'s phase 7; this adds where the host's
time goes.

    python -m mpi4jax_tpu_torch.benchmarks.hop_host

One JSON line: the host's us per call (its clock over 2000 back-to-back
calls, read before the closing synchronize, no profiler), and the top
functions by own time over 2000 calls under cProfile, as (function, us
per call with cProfile's own cost, calls per call).  It calls only
``ShallowWater`` and ``ring_shift2``, which every version of the port has,
so run from another tree's root it traces that tree's hop:

    (cd <tree> && PYTHONPATH=. python <this file> --label <name>)

Card only: a hop of CPU tensors is the plain version.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import time

import torch

from mpi4jax_tpu_torch.models.shallow_water import ShallowWater
from mpi4jax_tpu_torch.ops import _collectives as coll

SHAPE = (1800, 3600)
GRID = (2, 2)
CALLS = 2000
TOP = 12


def host_us(fn, calls):
    """The host's us per call over ``calls`` back-to-back calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def top_functions(fn, calls, top):
    """cProfile over ``calls`` calls: the ``top`` functions by own time,
    as (name, us per call, calls per call)."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    rows = sorted(((v[2], v[0], f"{k[0].rsplit('/', 2)[-1]}:{k[1]}:{k[2]}")
                   for k, v in pstats.Stats(prof).stats.items()),
                  reverse=True)[:top]
    return [(name, tt / calls * 1e6, nc / calls) for tt, nc, name in rows]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="names the tree in the line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hop_host: needs a CUDA card")
    dev = torch.device("cuda", 0)
    model = ShallowWater(SHAPE, grid=GRID, device=dev)
    strip = GRID + (4, 1, model.block_shape[1])
    g = torch.Generator().manual_seed(7)
    a, b = (torch.randn(strip, generator=g).to(dev) for _ in range(2))
    comm = model.grid.axis_comm(0)

    def call():
        return coll.ring_shift2(a, b, comm)

    rec = dict(label=args.label, payload_bytes=2 * a.numel() * 4,
               host_us_per_call=host_us(call, CALLS),
               top=top_functions(call, CALLS, TOP), torch=torch.__version__)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
