"""Divergent collectives after a matched warm-up: an op-code, a reduce-op
or a dtype mismatch at one program position (``MISMATCH_MODE``).

The torch twin of ``tests/world_programs/shm_schedule_mismatch.py``: the
verifier reports ``collective_mismatch``, ``reduce_op_mismatch`` or
``dtype_mismatch``.
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

comm = get_world_comm(device=DEVICE)
rank = comm.rank()
dev = comm.device

x = torch.arange(32.0, device=dev)
# a matched warm-up before the divergence
out = mt.allreduce(x, op=mt.SUM, comm=comm)
assert float(out[1]) == 2.0, out[1]
print(f"warmup ok r{rank}", flush=True)

mode = os.environ.get("MISMATCH_MODE", "opcode")
if mode == "opcode":
    # different collectives at the same program position
    if rank == 0:
        mt.allreduce(x, op=mt.SUM, comm=comm)
    else:
        mt.bcast(x, root=1, comm=comm)
elif mode == "reduce_op":
    # same collective, same bytes, divergent reduce op (SUM vs MAX)
    mt.allreduce(x, op=mt.SUM if rank == 0 else mt.MAX, comm=comm)
else:  # dtype: equal byte counts, different element type
    if rank == 0:
        mt.allreduce(x, op=mt.SUM, comm=comm)
    else:
        mt.allreduce(torch.arange(32, dtype=torch.int32, device=dev),
                     op=mt.SUM, comm=comm)
print("UNREACHABLE", flush=True)
