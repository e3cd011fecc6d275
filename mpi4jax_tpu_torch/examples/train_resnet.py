"""Data-parallel CNN training on synthetic data (demo CLI of the port).

The counterpart of ``examples/train_resnet.py``, by default on the card:

    python -m mpi4jax_tpu_torch.examples.train_resnet --steps 20 --batch 64

    # on the CPU, 2 dp ranks
    python -m mpi4jax_tpu_torch.examples.train_resnet --device cpu \\
        --ranks 2 --steps 2 --batch 8 --image 16 --depth 1 1 \\
        --widths 8 16

As in the JAX CLI: a residual CNN of ``--depth`` blocks per stage and
``--widths`` channels, 10 classes, the imagenet stem from 64-pixel images
up (else the small one), ``--batch`` images cut to a multiple of the
ranks, seeded normal images and labels, SGD at lr 0.05 over
allreduce-synced gradients.  The JAX CLI takes one rank per device; here
``--ranks`` dp ranks (default 1) share the one device.  A first step
(which builds the kernels) comes before the ``--steps`` timed ones; the
run prints the last loss and the ms per step, or with ``--json`` one JSON
line (``ranks``, ``batch``, ``losses`` of every step, ``ms_per_step``,
``device``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models import resnet
from ..parallel.mesh import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image", type=int, default=32)
    ap.add_argument("--depth", type=int, nargs="+", default=[2, 2, 2, 2])
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[32, 64, 128, 256])
    ap.add_argument("--ranks", type=int, default=1,
                    help="dp ranks, all on the one device (default 1)")
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--json", action="store_true",
                    help="print only the JSON line")
    args = ap.parse_args(argv)

    cfg = resnet.ResNetConfig(
        stages=tuple(args.depth), widths=tuple(args.widths), n_classes=10,
        stem="imagenet" if args.image >= 64 else "small")
    comm = make_mesh(args.ranks, device=args.device)
    batch = args.batch - args.batch % args.ranks
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(batch, args.image, args.image,
                                   3).astype(np.float32)).to(comm.device)
    y = torch.from_numpy(rng.randint(0, 10, (batch,)).astype(
        np.int32)).to(comm.device)

    params = resnet.params_from_numpy(resnet.init_params(cfg), args.ranks,
                                      comm.device)
    step = resnet.make_dp_train_step(cfg, comm, lr=0.05)
    loss, params = step(params, x, y)  # builds the kernels
    losses = [float(loss)]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss, params = step(params, x, y)
        losses.append(float(loss))
    dt = (time.perf_counter() - t0) / max(args.steps, 1)
    if args.json:
        print(json.dumps({"ranks": args.ranks, "batch": batch,
                          "losses": losses, "ms_per_step": dt * 1e3,
                          "device": str(comm.device)}))
    else:
        print(f"dp={args.ranks}: loss {losses[-1]:.4f}, {dt * 1e3:.1f} "
              f"ms/step (batch {batch}) on {comm.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
