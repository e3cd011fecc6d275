"""Bursts of small sends: the coalescing window, with a sendrecv ring and a
rendezvous collective between rounds.

The torch twin of ``tests/world_programs/coalesce_ops.py`` (run at np 3).
Raw send/recv traffic flows strictly down the rank order, so no pair
exchanges raw messages both ways; bidirectional flow rides the sendrecv.
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

K = 24                      # messages per directed pair, per round
SIZES = (3, 17, 64, 251)    # odd sizes exercise sub-frame parsing


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size >= 2, "run under the launcher with -n >= 2"
    dev = comm.device

    def send_burst(peer, round_):
        # K adjacent small sends to one peer — the coalescing window
        for i in range(K):
            n = SIZES[i % len(SIZES)]
            payload = torch.arange(n, dtype=torch.int32, device=dev) + (
                10000 * rank + 100 * round_ + i)
            mt.send(payload, dest=peer, tag=1000 * round_ + i, comm=comm)

    def recv_burst(peer, round_, digest):
        for i in range(K):
            n = SIZES[i % len(SIZES)]
            got = mt.recv(torch.zeros(n, dtype=torch.int32, device=dev),
                          source=peer, tag=1000 * round_ + i, comm=comm)
            expect = np.arange(n, dtype=np.int32) + (
                10000 * peer + 100 * round_ + i)
            np.testing.assert_array_equal(got.cpu().numpy(), expect)
            digest.update(got.cpu().numpy().tobytes())

    digest = hashlib.sha256()
    for round_ in range(3):
        if rank + 1 < size:
            send_burst(rank + 1, round_)
        if rank > 0:
            recv_burst(rank - 1, round_, digest)
        ring = mt.sendrecv(
            torch.full((16,), float(10 * rank + round_), dtype=torch.float32,
                       device=dev), shift=1, comm=comm)
        np.testing.assert_allclose(ring.cpu().numpy(),
                                   float(10 * ((rank - 1) % size) + round_))
        digest.update(ring.cpu().numpy().tobytes())
        # a rendezvous collective between rounds
        total = mt.allreduce(torch.ones(8, dtype=torch.float32, device=dev),
                             op=mt.SUM, comm=comm)
        np.testing.assert_allclose(total.cpu().numpy(), float(size))
        digest.update(total.cpu().numpy().tobytes())

    print(f"coalesce_ops digest r{rank} {digest.hexdigest()}", flush=True)
    print("coalesce_ops OK", flush=True)


if __name__ == "__main__":
    main()
