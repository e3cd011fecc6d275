"""neighbor_exchange: a periodic ring, a chain with walls, and the
explicit-token route.

The torch twin of ``tests/world_programs/neighbor_ops.py`` (run at np 3).
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

comm = get_world_comm(device=DEVICE)
rank, size = comm.rank(), comm.size()
assert size == 3
dev = comm.device

strip = torch.full((4,), float(rank), dtype=torch.float32, device=dev)

# periodic ring
lo, hi = (rank - 1) % size, (rank + 1) % size
f_lo, f_hi = mt.neighbor_exchange(strip, strip + 100, lo=lo, hi=hi,
                                  comm=comm)
# from_lo = lo's to_hi; from_hi = hi's to_lo
np.testing.assert_allclose(f_lo.cpu().numpy(), lo + 100.0)
np.testing.assert_allclose(f_hi.cpu().numpy(), float(hi))

# chain with walls (the twin's jitted step)
lo_w = rank - 1 if rank > 0 else None
hi_w = rank + 1 if rank < size - 1 else None


def step(s):
    a, b = mt.neighbor_exchange(s, s * 2, lo=lo_w, hi=hi_w, comm=comm)
    return a + b


out = step(strip).cpu().numpy()
want_lo = 2.0 * (rank - 1) if rank > 0 else 2.0 * rank  # wall passthrough
want_hi = float(rank + 1) if rank < size - 1 else float(rank)
np.testing.assert_allclose(out, want_lo + want_hi)

# explicit-token route
with mt.explicit_token_ordering():

    def tstep(s):
        token = mt.create_token(s)
        (a, b), token = mt.neighbor_exchange(
            s, s + 10, lo=lo, hi=hi, comm=comm, token=token)
        return a + b

    tout = tstep(strip).cpu().numpy()
    np.testing.assert_allclose(tout, (lo + 10.0) + hi)

print(f"neighbor_ops OK r{rank}", flush=True)
