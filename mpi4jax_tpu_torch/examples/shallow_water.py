"""Shallow-water demo / benchmark CLI of the PyTorch port.

The counterpart of ``examples/shallow_water.py``, by default on the card:

    # demo run
    python -m mpi4jax_tpu_torch.examples.shallow_water

    # benchmark: 1800x3600, 0.1 model days (the reference's headline config)
    python -m mpi4jax_tpu_torch.examples.shallow_water --benchmark --json

    # the same decomposed over a 2x2 process grid on the one card: the
    # plain step with its halo exchanges on the hop kernel
    python -m mpi4jax_tpu_torch.examples.shallow_water --benchmark \
        --grid 2 2 --json

    # on the CPU, through the plain step
    python -m mpi4jax_tpu_torch.examples.shallow_water --device cpu \\
        --size 32 64 --days 0.01

The timed region is the multistep loop only, ending in a synchronize: the
initial condition, the Euler bootstrap step, the kernel build and one
warm-up call come before the timer starts.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.shallow_water import ShallowWater, SWParams
from ..ops import _collectives


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, nargs=2, default=None,
                   help="domain (ny nx); default 180x360 (demo) or "
                        "1800x3600 (--benchmark)")
    p.add_argument("--days", type=float, default=None,
                   help="model days to simulate (default 10 demo / 0.1 bench)")
    p.add_argument("--benchmark", action="store_true",
                   help="benchmark config: big domain, short run")
    p.add_argument("--multistep", type=int, default=25,
                   help="steps per call of the stepper")
    p.add_argument("--fuse", type=int, default=3,
                   help="steps per kernel launch (1x1 grid)")
    p.add_argument("--grid", type=int, nargs=2, default=(1, 1),
                   metavar=("GY", "GX"), help="process grid (default 1 1)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line with the timing result")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain step)")
    return p.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(argv)
    ny, nx = (
        tuple(args.size)
        if args.size
        else ((1800, 3600) if args.benchmark else (180, 360))
    )
    days = args.days if args.days is not None else (0.1 if args.benchmark else 10.0)

    params = SWParams(dx=5e3, dy=5e3)
    grid = tuple(args.grid)
    model = ShallowWater((ny, nx), params, grid=grid, device=args.device)
    device = model.device
    n_steps = max(2, int(days * params.day_seconds / params.dt))
    multistep = max(1, min(args.multistep, n_steps - 1))
    whole, rest = divmod(n_steps - 1, multistep)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    print(
        f"shallow_water: domain ({ny}, {nx}), grid {grid}, device {device} "
        f"[{kind}], dt={params.dt:.2f}s, {n_steps} steps ({days} model days)"
    )

    first = model.step_fn(1, first=True, fuse=args.fuse)
    step = model.step_fn(multistep, fuse=args.fuse)
    tail = model.step_fn(rest, fuse=args.fuse)

    state = first(model.init())
    step(state)  # warm-up: builds the kernel
    _sync(device)

    hops, exchanges = _collectives.LAUNCHES["hop"], model.exchanges
    t0 = time.perf_counter()
    for _ in range(whole):
        state = step(state)
    state = tail(state)
    _sync(device)
    elapsed = time.perf_counter() - t0
    done = n_steps - 1
    hops = _collectives.LAUNCHES["hop"] - hops
    exchanges = model.exchanges - exchanges

    h = model.interior(state.h)
    if not np.all(np.isfinite(h)):
        raise RuntimeError("solution diverged")
    print(f"solution took {elapsed:.3f} s ({done / elapsed:.1f} steps/s, "
          f"h range [{h.min():.2f}, {h.max():.2f}])")

    result = {
        "domain": [ny, nx], "grid": list(grid), "device": kind,
        "fuse": args.fuse, "steps": done, "seconds": elapsed,
        "ms_per_step": elapsed / done * 1e3,
        "steps_per_s": done / elapsed,
        "hop_launches": hops, "halo_exchanges_per_step": exchanges / done,
    }
    if args.json:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
