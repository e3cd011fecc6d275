"""Batched world ops: what the twin's ``jax.vmap`` puts on the wire.

The torch twin of ``tests/world_programs/vmap_ops.py``.  A vmap of a world
op issues ONE message carrying the whole batch; the port's world ops have
no vmap rule, so each batched call is the op on the stacked tensor, with
the batch axis where the twin's batching rule puts it (the alltoall's and
the scatter's batch moves behind the rank axis) and the output transposed
where the batched output is.  Each is checked against the loop of
per-slice calls, as in the twin.
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
    B, N = 3, 4

    x = (torch.arange(B * N, dtype=torch.float32, device=dev).reshape(B, N)
         + 100 * rank)

    # allreduce: batched == loop
    vm = mt.allreduce(x, op=mt.SUM, comm=comm)
    loop = torch.stack(
        [mt.allreduce(x[i], op=mt.SUM, comm=comm) for i in range(B)])
    np.testing.assert_allclose(vm.cpu().numpy(), loop.cpu().numpy())

    # allgather: out (size, N) per slice -> batched out (B, size, N)
    vm = mt.allgather(x, comm=comm).transpose(0, 1)
    assert tuple(vm.shape) == (B, size, N), vm.shape
    loop = torch.stack([mt.allgather(x[i], comm=comm) for i in range(B)])
    np.testing.assert_allclose(vm.cpu().numpy(), loop.cpu().numpy())

    # gather: rank-dependent output — the root's (B, size, N) stacks, a
    # non-root gets its batched input back
    vm = mt.gather(x, root=0, comm=comm)
    if rank == 0:
        vm = vm.transpose(0, 1)
        assert tuple(vm.shape) == (B, size, N), vm.shape
    else:
        assert tuple(vm.shape) == (B, N), vm.shape
        np.testing.assert_allclose(vm.cpu().numpy(), x.cpu().numpy())
    loop = torch.stack([mt.gather(x[i], root=0, comm=comm)
                        for i in range(B)])
    np.testing.assert_allclose(vm.cpu().numpy(), loop.cpu().numpy())

    # alltoall: per-slice input (size, 2), batched (B, size, 2), the batch
    # behind the rank axis on the wire
    a2a_in = (torch.arange(B * size * 2, dtype=torch.float32,
                           device=dev).reshape(B, size, 2) + 1000 * rank)
    vm = mt.alltoall(a2a_in.transpose(0, 1).contiguous(),
                     comm=comm).transpose(0, 1)
    loop = torch.stack([mt.alltoall(a2a_in[i], comm=comm)
                        for i in range(B)])
    np.testing.assert_allclose(vm.cpu().numpy(), loop.cpu().numpy())

    # scatter: per-slice input (size, 2), out (2,) -> batched out (B, 2)
    sc_in = (torch.arange(size, dtype=torch.float32,
                          device=dev)[None, :, None].repeat(B, 1, 2)
             + torch.arange(B, dtype=torch.float32, device=dev)[:, None,
                                                                 None])
    vm = mt.scatter(sc_in.transpose(0, 1).contiguous(), root=0, comm=comm)
    assert tuple(vm.shape) == (B, 2)
    loop = torch.stack([mt.scatter(sc_in[i], root=0, comm=comm)
                        for i in range(B)])
    np.testing.assert_allclose(vm.cpu().numpy(), loop.cpu().numpy())

    # a batch on axis 1: the message keeps it there
    xt = x.T.contiguous()  # (N, B)
    vm = mt.allgather(xt, comm=comm).permute(2, 0, 1)
    np.testing.assert_allclose(
        vm.cpu().numpy(),
        torch.stack([mt.allgather(xt[:, i].contiguous(), comm=comm)
                     for i in range(B)]).cpu().numpy())

    # a batched function of two ops
    vm = mt.allreduce(mt.bcast(x, root=0, comm=comm), op=mt.SUM, comm=comm)
    assert tuple(vm.shape) == (B, N)

    # batched send/recv pair: one message carries the whole batch
    if rank == 0:
        mt.send(x, dest=1, comm=comm)
    elif rank == 1:
        got = mt.recv(torch.zeros_like(x), source=0, comm=comm)
        np.testing.assert_allclose(
            got.cpu().numpy(),
            np.arange(B * N, dtype=np.float32).reshape(B, N))

    print(f"rank {rank}: vmap_ops OK", flush=True)


if __name__ == "__main__":
    main()
