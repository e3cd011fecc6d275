"""Sub-communicators: split (rows, columns, a reversed key, an opt-out
color) and dup, with collectives and a sendrecv on them.

The torch twin of ``tests/world_programs/subcomm_ops.py`` (run at np 4).
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
    world = get_world_comm(device=DEVICE)
    rank, size = world.rank(), world.size()
    assert size == 4, "run with -n 4"
    dev = world.device

    row_id, col_id = divmod(rank, 2)

    # row communicators: {0,1} and {2,3}
    row = world.split(color=row_id)
    assert row.size() == 2 and row.rank() == col_id, (row, rank)

    # column communicators: {0,2} and {1,3}
    col = world.split(color=col_id)
    assert col.size() == 2 and col.rank() == row_id, (col, rank)

    x = torch.tensor(float(rank), dtype=torch.float32, device=dev)

    # row-wise sum: ranks (0,1) -> 1, ranks (2,3) -> 5
    got = mt.allreduce(x, op=mt.SUM, comm=row)
    assert float(got) == [1.0, 1.0, 5.0, 5.0][rank], (rank, float(got))

    # column-wise sum (the twin's jitted call): (0,2) -> 2, (1,3) -> 4
    got = (lambda v: mt.allreduce(v, op=mt.SUM, comm=col))(x)
    assert float(got) == [2.0, 4.0, 2.0, 4.0][rank], (rank, float(got))

    # point-to-point within a row: exchange with the row partner
    other = 1 - row.rank()
    res = mt.sendrecv(torch.full((2,), float(rank), device=dev),
                      source=other, dest=other, comm=row)
    partner_world_rank = row_id * 2 + other
    np.testing.assert_allclose(res.cpu().numpy(), float(partner_world_rank))

    # allgather on the column comm: stacking order follows sub-rank
    ag = mt.allgather(x, comm=col)
    np.testing.assert_allclose(ag.cpu().numpy(),
                               [float(col_id), float(col_id + 2)])

    # dup: same membership, isolated message space
    wdup = world.dup()
    assert wdup.size() == size and wdup.rank() == rank
    got = mt.allreduce(x, op=mt.SUM, comm=wdup)
    assert float(got) == 6.0, float(got)

    # parent and child comms interleaved in one function
    def mixed(v):
        a = mt.allreduce(v, op=mt.SUM, comm=row)
        b = mt.allreduce(a, op=mt.SUM, comm=world)
        return mt.allreduce(b, op=mt.MAX, comm=col)

    got = mixed(x)
    # row sums (1,1,5,5) -> world sum = 12 everywhere -> max = 12
    assert float(got) == 12.0, float(got)

    # key reverses the sub-rank order
    rev = world.split(color=row_id, key=-rank)
    assert rev.rank() == 1 - col_id, (rev, rank)

    # opt-out color: odd ranks get no comm; even ranks form a pair
    sub = world.split(color=0 if rank % 2 == 0 else -1)
    if rank % 2:
        assert sub is None, sub
    else:
        assert sub.size() == 2 and sub.rank() == rank // 2, (sub, rank)
        got = mt.allreduce(x, op=mt.SUM, comm=sub)
        assert float(got) == 2.0, float(got)

    # the same function on two comms gives each comm's result
    def f(v, c):
        return mt.allreduce(v, op=mt.SUM, comm=c)

    assert float(f(x, row)) == [1.0, 1.0, 5.0, 5.0][rank]
    assert float(f(x, col)) == [2.0, 4.0, 2.0, 4.0][rank]

    print(f"subcomm_ops OK (rank {rank})")


if __name__ == "__main__":
    main()
