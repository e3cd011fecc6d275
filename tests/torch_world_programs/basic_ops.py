"""Per-rank correctness program for the port's world-tier ops (run under
the launcher, or the static verifier).

The torch twin of ``tests/world_programs/basic_ops.py``: the same ops,
peers, tags, roots, dtypes, shapes and order.  A jitted call is a plain
call here, and ``lax.scan`` a Python loop.  Any assertion failure exits
non-zero, which the launcher turns into a failed job.

    python -m mpi4jax_tpu_torch.runtime.launch -n 2 basic_ops.py --device cpu
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
    assert size >= 2, "run under the launcher with -n >= 2"
    dev = comm.device

    x = torch.arange(4, dtype=torch.float32, device=dev) + rank

    # allreduce: eager, and the twin's jitted call
    expected_sum = np.arange(4) * size + sum(range(size))
    out = mt.allreduce(x, op=mt.SUM, comm=comm)
    np.testing.assert_allclose(out.cpu().numpy(), expected_sum)
    out = (lambda v: mt.allreduce(v, op=mt.SUM, comm=comm))(x)
    np.testing.assert_allclose(out.cpu().numpy(), expected_sum)
    # input not mutated
    np.testing.assert_allclose(x.cpu().numpy(), np.arange(4) + rank)

    out = mt.allreduce(x, op=mt.MAX, comm=comm)
    np.testing.assert_allclose(out.cpu().numpy(), np.arange(4) + size - 1)

    # allgather
    ag = mt.allgather(x, comm=comm)
    assert tuple(ag.shape) == (size, 4)
    for r in range(size):
        np.testing.assert_allclose(ag[r].cpu().numpy(), np.arange(4) + r)

    # alltoall: row j -> rank j
    a2a_in = torch.tensor([[100 * rank + j] for j in range(size)],
                          dtype=torch.int32, device=dev)
    a2a = mt.alltoall(a2a_in, comm=comm)
    np.testing.assert_array_equal(
        a2a.cpu().numpy().ravel(), [100 * r + rank for r in range(size)])

    # bcast
    b = torch.full((3,), float(rank), dtype=torch.float32, device=dev)
    b = mt.bcast(b, root=1, comm=comm)
    np.testing.assert_allclose(b.cpu().numpy(), 1.0)

    # reduce: root gets the reduction, the others their input
    red = mt.reduce(x, op=mt.SUM, root=0, comm=comm)
    if rank == 0:
        np.testing.assert_allclose(red.cpu().numpy(), expected_sum)
    else:
        np.testing.assert_allclose(red.cpu().numpy(), x.cpu().numpy())

    # scan (inclusive prefix)
    sc = mt.scan(torch.tensor([float(rank + 1)], device=dev), op=mt.SUM,
                 comm=comm)
    np.testing.assert_allclose(sc.cpu().numpy(), [sum(range(1, rank + 2))])

    # gather / scatter (the root stacks, a non-root gets its input back)
    g = mt.gather(x, root=0, comm=comm)
    if rank == 0:
        assert tuple(g.shape) == (size, 4), g.shape
        for r in range(size):
            np.testing.assert_allclose(g[r].cpu().numpy(), np.arange(4) + r)
    else:
        assert tuple(g.shape) == (4,), g.shape
        np.testing.assert_allclose(g.cpu().numpy(), x.cpu().numpy())
    sc_in = torch.arange(size, dtype=torch.float32,
                         device=dev)[:, None].repeat(1, 2)
    mine = mt.scatter(sc_in, root=0, comm=comm)
    np.testing.assert_allclose(mine.cpu().numpy(), float(rank))

    # barrier
    mt.barrier(comm=comm)

    # sendrecv ring (the twin's jitted call)
    ring = (lambda v: mt.sendrecv(v, shift=1, comm=comm))(x)
    np.testing.assert_allclose(ring.cpu().numpy(),
                               np.arange(4) + (rank - 1) % size)

    # send / recv pair (true MPMD)
    if rank == 0:
        mt.send(x * 2, dest=1, comm=comm)
    elif rank == 1:
        got = mt.recv(torch.zeros_like(x), source=0, comm=comm)
        np.testing.assert_allclose(got.cpu().numpy(), np.arange(4) * 2.0)

    # the twin's lax.scan of three steps
    carry = torch.ones((2,), dtype=torch.float32, device=dev)
    for _ in range(3):
        carry = mt.allreduce(carry, op=mt.SUM, comm=comm) / size
    np.testing.assert_allclose(carry.cpu().numpy(), 1.0, rtol=1e-6)

    print(f"rank {rank}: basic_ops OK", flush=True)


if __name__ == "__main__":
    main()
