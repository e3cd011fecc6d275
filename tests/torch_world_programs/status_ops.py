"""Status introspection: sendrecv and recv filling a ``Status``, split
tags, ``ANY_TAG``, a short message into a larger buffer, the gradient of a
split-tag sendrecv, and the token API's status.

The torch twin of ``tests/world_programs/status_ops.py`` (run at np 2).
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
    assert size == 2, "run with -n 2"
    other = 1 - rank
    dev = comm.device

    arr = torch.ones((3, 2), dtype=torch.float32, device=dev) * rank

    # sendrecv + status
    status = mt.Status()
    res = mt.sendrecv(arr, source=other, dest=other, status=status,
                      comm=comm)
    np.testing.assert_allclose(res.cpu().numpy(), other)
    assert status.Get_source() == other, status
    assert status.Get_tag() == 0, status
    assert status.Get_count() == arr.numel() * 4, status
    assert status.Get_count(np.float32) == arr.numel(), status

    # sendrecv + status (the twin's jitted call)
    status2 = mt.Status()
    res = (lambda v: mt.sendrecv(v, source=other, dest=other,
                                 status=status2, comm=comm))(arr)
    np.testing.assert_allclose(res.cpu().numpy(), other)
    assert status2.Get_source() == other, status2
    assert status2.Get_count(np.float32) == arr.numel(), status2

    # split tags: each rank sends with its own tag; ANY_TAG recv reports it
    status3 = mt.Status()
    res = mt.sendrecv(arr, source=other, dest=other, sendtag=10 + rank,
                      recvtag=mt.ANY_TAG, status=status3, comm=comm)
    np.testing.assert_allclose(res.cpu().numpy(), other)
    assert status3.Get_tag() == 10 + other, status3

    # recv + status (+ default ANY_TAG), with an explicitly tagged send
    status4 = mt.Status()
    if rank == 0:
        mt.send(arr, dest=1, tag=7, comm=comm)
    else:
        out = mt.recv(arr, source=0, status=status4, comm=comm)
        np.testing.assert_allclose(out.cpu().numpy(), 0.0)
        assert status4.Get_source() == 0, status4
        assert status4.Get_tag() == 7, status4
        assert status4.Get_count(np.float32) == arr.numel(), status4

    # short message into a larger buffer: count reports actual bytes
    if rank == 0:
        mt.send(torch.arange(2, dtype=torch.float32, device=dev), dest=1,
                tag=3, comm=comm)
    else:
        big = torch.zeros((6,), dtype=torch.float32, device=dev)
        status5 = mt.Status()
        out = mt.recv(big, source=0, tag=3, status=status5, comm=comm)
        np.testing.assert_allclose(out.cpu().numpy()[:2], [0.0, 1.0])
        assert status5.Get_count(np.float32) == 2, status5

    # the gradient of a split-tag sendrecv swaps the tags along with
    # source and dest (the forward matched sendtag(s) == recvtag(d))
    v = arr.clone().requires_grad_(True)
    mt.sendrecv(v, source=other, dest=other, sendtag=rank + 1,
                recvtag=other + 1, comm=comm).sum().backward()
    np.testing.assert_allclose(v.grad.cpu().numpy(), 1.0)

    # the explicit-token API carries status too
    from mpi4jax_tpu_torch.compat import token_api

    status6 = mt.Status()
    res, tok = token_api.sendrecv(arr, source=other, dest=other,
                                  status=status6, comm=comm)
    np.testing.assert_allclose(res.cpu().numpy(), other)
    assert status6.Get_source() == other, status6

    print(f"status_ops OK (rank {rank})")


if __name__ == "__main__":
    main()
