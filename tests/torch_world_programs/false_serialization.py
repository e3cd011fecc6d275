"""False serialization: a ring of large sends and receives with local
compute between them, the window a hoisted receive overlaps.

The torch twin of ``tests/world_programs/false_serialization.py`` (run at
np 3: np 2 is a bidirectional exchange).
"""

import hashlib
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

BLOCK = 64 * 1024  # f32: 256 KB, past any buffered-send threshold


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size >= 3, "run at np >= 3 (np=2 is a bidirectional exchange)"
    nxt, prv = (rank + 1) % size, (rank - 1) % size
    dev = comm.device

    def stage(block, tag):
        mt.send(block, dest=nxt, tag=tag, comm=comm)
        # local compute between the send and the recv: the window the
        # hoisted recv post overlaps with
        local = torch.tanh(block[:1024]).sum()
        got = mt.recv(torch.zeros((BLOCK,), dtype=torch.float32,
                                  device=dev), source=prv, tag=tag,
                      comm=comm)
        return got, local

    block0 = torch.full((BLOCK,), float(rank), dtype=torch.float32,
                        device=dev)
    got1, _ = stage(block0, tag=11)
    np.testing.assert_allclose(got1[:4].cpu().numpy(), float(prv))

    got2, _ = stage(got1 * 2.0 + 1.0, tag=12)
    two_back = (rank - 2) % size
    np.testing.assert_allclose(got2[:4].cpu().numpy(), two_back * 2.0 + 1.0)

    digest = hashlib.sha256(
        got1.cpu().numpy().tobytes() + got2.cpu().numpy().tobytes()
    ).hexdigest()
    print(f"false_serialization digest r{rank} {digest}", flush=True)
    print(f"rank {rank}: false_serialization OK", flush=True)


if __name__ == "__main__":
    main()
