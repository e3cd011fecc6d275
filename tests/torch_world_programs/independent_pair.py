"""Independent small-transfer pairs: coalescing and deferral territory.

The torch twin of ``tests/world_programs/independent_pair.py`` (run at
np 2).  Two ranks exchange bursts of small messages on disjoint tags.
Every send fits the buffered-send threshold, so the exchange is not
order-critical, and the execution plan marks the adjacent same-peer sends
for coalescing.  Values are tag-addressed, so any cross-delivery fails an
assertion.

    python -m mpi4jax_tpu_torch.runtime.launch -n 2 independent_pair.py --device cpu
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

BURST = 3
MSG = 64  # f32: 256 B, always below the coalesce/detach thresholds


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size == 2, "run at np = 2"
    peer = 1 - rank
    dev = comm.device

    zero = torch.zeros((MSG,), dtype=torch.float32, device=dev)
    for round_ in range(2):
        base = 100 * round_
        # a burst of adjacent small sends to ONE peer
        for i in range(BURST):
            mt.send(torch.full((MSG,), float(10 * rank + i + base),
                               device=dev),
                    dest=peer, tag=base + i, comm=comm)
        for i in range(BURST):
            got = mt.recv(zero, source=peer, tag=base + i, comm=comm)
            np.testing.assert_allclose(got.cpu().numpy(),
                                       float(10 * peer + i + base))

    print(f"rank {rank}: independent_pair OK", flush=True)


if __name__ == "__main__":
    main()
