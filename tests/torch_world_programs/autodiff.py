"""Gradients through world ops: what the twin's jvp, grad and transposes
send.

The torch twin of ``tests/world_programs/autodiff.py``.  ``jax.jvp`` is
the op on the primal and on the tangent; ``jax.grad`` is autograd (the SUM
allreduce's backward passes the cotangent, the sendrecv's sends it back
along the edge, source and destination swapped); a transpose that the twin
takes without running the op is what it sends: the allreduce's is the
identity (no message), transposed twice it is the allreduce, and the
ring's transpose is the ring shifted the other way.  On a card, autograd
runs the backward on its own device thread.
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
    dev = comm.device
    x = torch.arange(3, dtype=torch.float32, device=dev) + 1.0

    f = lambda v: mt.allreduce(v, op=mt.SUM, comm=comm)  # noqa: E731

    # jvp: the tangent allreduces along
    y, ty = f(x), f(torch.ones_like(x))
    np.testing.assert_allclose(y.cpu().numpy(), (np.arange(3) + 1) * size)
    np.testing.assert_allclose(ty.cpu().numpy(), float(size))

    # grad through a scalar loss
    v = x.clone().requires_grad_(True)
    f(v).sum().backward()
    np.testing.assert_allclose(v.grad.cpu().numpy(), 1.0)

    # the transpose: identity per rank (replicated cotangent), no message
    ct = torch.ones_like(x)
    np.testing.assert_allclose(ct.cpu().numpy(), 1.0)

    # double transpose == allreduce
    dt = mt.allreduce(x, op=mt.SUM, comm=comm)
    np.testing.assert_allclose(dt.cpu().numpy(), f(x).cpu().numpy())

    # the sendrecv's transpose swaps direction: shift +1 transposes to -1
    sr = lambda v: mt.sendrecv(v, shift=1, comm=comm)  # noqa: E731
    mine = torch.tensor([float(rank)], device=dev)
    ct = mt.sendrecv(mine, shift=-1, comm=comm)
    np.testing.assert_allclose(ct.cpu().numpy(), [(rank + 1) % size])

    # jvp through the sendrecv
    sr(mine)
    tsr = sr(mine * 2)
    np.testing.assert_allclose(tsr.cpu().numpy(),
                               [2.0 * ((rank - 1) % size)])

    # grad through the sendrecv composed with the allreduce
    def loss(v):
        moved = mt.sendrecv(v, shift=1, comm=comm)
        return mt.allreduce((moved * v).sum(), op=mt.SUM, comm=comm)

    v = mine.clone().requires_grad_(True)
    loss(v).backward()
    # d/dv_r [sum_s v_{s-1} v_s] = v_{r-1} + v_{r+1}
    np.testing.assert_allclose(
        v.grad.cpu().numpy(),
        [float((rank - 1) % size + (rank + 1) % size)])

    print(f"rank {rank}: autodiff OK", flush=True)


if __name__ == "__main__":
    main()
