"""Ordering: a hot potato of dependent send/recv, a deadlock-by-
construction exchange that strict program order keeps safe, and nested
functions of collectives.

The torch twin of ``tests/world_programs/ordering.py``.  The exchange is
correct only under program order: with the progress engine off the
verifier reports it (``order_critical_exchange``), with it on (the
default) the small sends are detached and it is clean.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size >= 2
    dev = comm.device

    zero = torch.zeros((1,), dtype=torch.float32, device=dev)

    # --- hot potato: value accumulates operations in strict sequence ----
    def potato_rank0(v):
        # send v, get back 3v+1, send 2*(3v+1), get back final
        mt.send(v, dest=1, comm=comm)
        v1 = mt.recv(zero, source=1, comm=comm)
        mt.send(v1 * 2.0, dest=1, comm=comm)
        v2 = mt.recv(zero, source=1, comm=comm)
        return v2

    def potato_rank1():
        a = mt.recv(zero, source=0, comm=comm)
        mt.send(a * 3.0 + 1.0, dest=0, comm=comm)
        b = mt.recv(zero, source=0, comm=comm)
        mt.send(b - 5.0, dest=0, comm=comm)
        return b

    if rank == 0:
        out = potato_rank0(torch.tensor([7.0], device=dev))
        # ((7*3+1)*2) - 5 = 39
        np.testing.assert_allclose(out.cpu().numpy(), [39.0])
    elif rank == 1:
        potato_rank1()

    # --- deadlock-by-construction ordering ------------------------------
    if rank == 0:
        mt.send(torch.tensor([13.0], device=dev), dest=1, comm=comm)
        got = mt.recv(zero, source=1, comm=comm)
        np.testing.assert_allclose(got.cpu().numpy(), [17.0])
    elif rank == 1:
        got = mt.recv(zero, source=0, comm=comm)
        np.testing.assert_allclose(got.cpu().numpy(), [13.0])
        mt.send(torch.tensor([17.0], device=dev), dest=0, comm=comm)

    # --- ordering across nested functions -------------------------------
    def inner(v):
        return mt.allreduce(v, op=mt.SUM, comm=comm)

    def outer(v):
        a = inner(v)
        b = mt.allreduce(a, op=mt.MAX, comm=comm)
        return inner(b)

    out = outer(torch.tensor([1.0], device=dev))
    np.testing.assert_allclose(out.cpu().numpy(), [float(size * size)])

    print(f"rank {rank}: ordering OK", flush=True)


if __name__ == "__main__":
    main()
