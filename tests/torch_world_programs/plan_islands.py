"""Plan execution on a world of two islands: the leg stays off.

Run at np 4 on ``--fake-hosts 'r0,r1|r2,r3'``.  A ring of sends and
receives (the traffic a plan rewrites) around an f32 SUM allreduce forced
to ``algo="hring"``, the call the intra-island leg takes when it is
eligible.  Each rank prints a digest of what it received and reduced, and
one ``plan_islands state`` JSON line: whether a plan runner is installed,
and whether any of the leg's phases ran (``topo/_ici_leg.PHASE_SECONDS``;
the analyzer's virtual world has no handle to ask the leg's status of).
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch.runtime import planrt  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402
from mpi4jax_tpu_torch.topo import _ici_leg  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")

BLOCK = 16 * 1024  # f32: 64 KB a ring message
COUNT = 70000      # f32 elements a rank in the allreduce


def main():
    comm = get_world_comm(device=DEVICE)
    rank, size = comm.rank(), comm.size()
    assert size == 4, "run at np 4 on --fake-hosts 'r0,r1|r2,r3'"
    nxt, prv = (rank + 1) % size, (rank - 1) % size
    dev = comm.device

    def ring(block, tag):
        mt.send(block, dest=nxt, tag=tag, comm=comm)
        return mt.recv(torch.zeros((BLOCK,), dtype=torch.float32,
                                   device=dev), source=prv, tag=tag,
                       comm=comm)

    got1 = ring(torch.full((BLOCK,), float(rank), dtype=torch.float32,
                           device=dev), tag=21)
    x = np.random.default_rng(100 + rank).standard_normal(COUNT)
    total = mt.allreduce(torch.from_numpy(x.astype(np.float32)).to(dev),
                         comm=comm, algo="hring")
    got2 = ring(got1 * 2.0 + total[:BLOCK], tag=22)

    digest = hashlib.sha256(
        got1.cpu().numpy().tobytes() + total.cpu().numpy().tobytes()
        + got2.cpu().numpy().tobytes()).hexdigest()
    print(f"plan_islands digest r{rank} {digest}", flush=True)
    state = {
        "rank": rank,
        "plan": planrt.active(),
        "leg_ran": sum(_ici_leg.PHASE_SECONDS.values()) > 0,
    }
    print("plan_islands state " + json.dumps(state), flush=True)


if __name__ == "__main__":
    main()
