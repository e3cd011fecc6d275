"""World-tier hello: one process per rank, the launcher's quickstart.

The counterpart of ``examples/world_hello.py``.  The reference's
quickstart is ``mpirun -n 4 python script.py``; here the port's launcher
plays that role::

    python -m mpi4jax_tpu_torch.runtime.launch -n 4 \\
        -m mpi4jax_tpu_torch.examples.world_hello            # on the card
    python -m mpi4jax_tpu_torch.runtime.launch -n 4 \\
        -m mpi4jax_tpu_torch.examples.world_hello -- --device cpu

Each rank is one process; ``get_default_comm()`` returns the world
communicator wired up from the launcher's environment, on ``cuda:0`` (all
ranks share one card) unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import sys

import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.runtime import transport


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not transport.in_world():  # a launched rank, or the verifier's
        sys.exit("run me under the launcher: python -m "
                 "mpi4jax_tpu_torch.runtime.launch -n 4 -m "
                 "mpi4jax_tpu_torch.examples.world_hello")
    comm = transport.get_world_comm(device=args.device)
    with comm:
        rank, size = comm.rank(), comm.size()
        dev = comm.device

        # collective: every rank contributes, every rank receives
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        total = mt.allreduce(x, op=mt.SUM)

        # point-to-point ring (per-rank source/dest: true MPMD)
        ring = mt.sendrecv(x, shift=1)

        # wildcard receive with status introspection (rank 0 drains all)
        if rank == 0:
            sources = []
            for _ in range(size - 1):
                status = mt.Status()
                mt.recv(x, source=mt.ANY_SOURCE, tag=1, status=status)
                sources.append(status.Get_source())
            print(f"rank 0 heard from ranks {sorted(sources)}", flush=True)
        else:
            mt.send(x, dest=0, tag=1)

        # a user-defined reduction (the MPI_Op_create analog)
        absmax = mt.custom_op(
            "ABSMAX", lambda a, b: torch.maximum(a.abs(), b.abs()))
        peak = mt.allreduce(torch.tensor(rank - 1.5, device=dev), op=absmax)

    print(f"rank {rank}/{size} on {dev}: sum={total[:2].tolist()} "
          f"ring={ring[:2].tolist()} absmax={float(peak)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
