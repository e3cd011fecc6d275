"""Gradient synchronization on a world comm, per leaf and bucketed.

The torch twin of ``tests/world_programs/bucketed_dp_grad.py`` (run at
np 2): twelve 2 KB leaves, synced one allreduce each, then in one 64 KB
bucket, the two results equal bit for bit.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi4jax_tpu_torch.parallel import dp  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402
from mpi4jax_tpu_torch.utils import tree  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")

N_LAYERS = 6
LEAF = 512  # f32: 2 KB per leaf — bucketable


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size >= 2, "run under the launcher with -n >= 2"
    dev = comm.device

    grads = {
        f"layer{i}": {
            "w": torch.full((LEAF,), float(rank + i), dtype=torch.float32,
                            device=dev),
            "b": torch.arange(LEAF, dtype=torch.float32,
                              device=dev) * (rank - i),
        }
        for i in range(N_LAYERS)
    }

    per_leaf = dp.sync_gradients(grads, comm=comm, bucket_bytes=0)
    bucketed = dp.sync_gradients(grads, comm=comm, bucket_bytes=64 * 1024)

    flat_a, _ = tree.flatten(per_leaf)
    flat_b, _ = tree.flatten(bucketed)
    assert len(flat_a) == len(flat_b) == 2 * N_LAYERS
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())

    # spot-check a value against the closed form
    want = np.full((LEAF,), sum(range(size)) / size + 2, np.float32)
    np.testing.assert_allclose(per_leaf["layer2"]["w"].cpu().numpy(), want)

    print(f"rank {rank}: bucketed_dp_grad OK", flush=True)


if __name__ == "__main__":
    main()
