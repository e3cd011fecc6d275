"""Protocol-error fail-fast: mismatched tags must abort, not hang.

The torch twin of ``tests/world_programs/tag_mismatch.py``.  The transport
matches messages strictly in order; a tag mismatch is a program error
reported as an abort, and the static verifier names it before any rank
starts (``tag_mismatch``).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")


def main():
    comm = get_world_comm(device=DEVICE)
    rank = comm.rank()
    x = torch.arange(3, dtype=torch.float32, device=comm.device)
    if rank == 0:
        mt.send(x, dest=1, tag=5, comm=comm)
    elif rank == 1:
        mt.recv(x, source=0, tag=7, comm=comm)  # wrong tag -> abort
    print("UNREACHABLE-OK" if rank != 1 else "UNREACHABLE", flush=True)


if __name__ == "__main__":
    main()
