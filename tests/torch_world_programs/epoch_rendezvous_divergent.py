"""The broken epoch rendezvous: non-root ranks gate the payload bcast on
local state instead of the header they received, so rank 0 enters the
payload collective alone (``collective_mismatch``).

The torch twin of ``tests/world_programs/epoch_rendezvous_divergent.py``.
"""

import json
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

PERIOD = 4      # rendezvous every 4th collective boundary
STEPS = 16
PROPOSE_AT = 8  # rank 0 has a pending table at this boundary


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size >= 2, "run under the launcher with -n >= 2"
    dev = comm.device

    epoch = 0
    local_saw_proposal = False  # the bug: never updated off the wire
    x = torch.arange(8, dtype=torch.int32, device=dev) + 1
    for step in range(1, STEPS + 1):
        mt.allreduce(x + step, op=mt.SUM, comm=comm)
        if step % PERIOD:
            continue

        # --- header bcast: (proposed_epoch, payload_len), root 0 ---
        if rank == 0 and step == PROPOSE_AT and epoch == 0:
            payload = np.frombuffer(
                json.dumps({"allreduce": [[0, "rd"]]}).encode(),
                dtype=np.uint8)
            hdr = torch.tensor([epoch + 1, payload.size], dtype=torch.int32,
                               device=dev)
        else:
            payload = None
            hdr = torch.tensor([epoch, 0], dtype=torch.int32, device=dev)
        hdr = mt.bcast(hdr, root=0, comm=comm)
        new_epoch, nbytes = int(hdr[0]), int(hdr[1])

        # BUG: non-root ranks ignore the header they just received and
        # gate the payload bcast on local state -> rank 0 enters the
        # payload collective alone.
        take = (new_epoch > epoch and nbytes > 0) if rank == 0 \
            else local_saw_proposal
        if not take:
            continue
        buf = (torch.from_numpy(payload.copy()).to(dev) if rank == 0
               else torch.zeros((nbytes,), dtype=torch.uint8, device=dev))
        mt.bcast(buf, root=0, comm=comm)
        epoch = new_epoch

    print("UNREACHABLE" if rank == 0 else "UNREACHABLE-OK", flush=True)


if __name__ == "__main__":
    main()
