"""Halo exchange on a 1-D ring: the stencil code's communication shape.

The torch twin of ``tests/world_programs/halo_exchange.py`` (run at np 3).
Each rank exchanges boundary halos with both neighbours through two
``sendrecv`` calls on disjoint channels, then applies a 3-point stencil;
the values are checked against numpy on the assembled ring.
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

STRIP = 4096


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size >= 2, "run under the launcher with -n >= 2"
    dev = comm.device

    strip = (torch.arange(STRIP, dtype=torch.float32, device=dev)
             + rank * STRIP)

    for step in range(2):
        # halo to the right neighbour / from the left, then the mirror
        from_left = mt.sendrecv(strip[-1:], shift=1, comm=comm,
                                sendtag=20 + step)
        from_right = mt.sendrecv(strip[:1], shift=-1, comm=comm,
                                 sendtag=40 + step)
        left = torch.cat([from_left, strip[:-1]])
        right = torch.cat([strip[1:], from_right])
        strip = 0.25 * left + 0.5 * strip + 0.25 * right

    # numpy reference over the assembled global ring
    world = np.arange(STRIP * size, dtype=np.float32)
    for _ in range(2):
        world = (0.25 * np.roll(world, 1) + 0.5 * world
                 + 0.25 * np.roll(world, -1))
    mine = world[rank * STRIP:(rank + 1) * STRIP]
    np.testing.assert_allclose(strip.cpu().numpy(), mine, rtol=1e-6)

    print(f"rank {rank}: halo_exchange OK", flush=True)


if __name__ == "__main__":
    main()
