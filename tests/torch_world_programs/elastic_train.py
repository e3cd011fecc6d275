"""Elastic DP training at the op level: the torch twin of
``tests/world_programs/elastic_train.py``.

Each step syncs a gradient that is the same on every rank with a MAX
allreduce, whose result is bit for bit the same at any world size (a
SUM-mean would round differently at np 3 and at the shrunk np 2), so the
trajectory does not depend on the world size: a run that loses a rank,
shrinks (or respawns), restores the last committed checkpoint and finishes
must print the digest of an uninterrupted run.  That pins the whole
recovery: ``RankFailure``, the generation files, ``tpucomm_shrink``, the
rebind and the checkpoints.  The tensors live on ``--device`` and the
allreduces are the port's staged world ops.

``--sum-term`` adds a float32 SUM allreduce per step to which only rank 0
contributes (exact at any size), so a job on two islands with
``MPI4JAX_TPU_COLL_ALGO=allreduce=hring`` runs the intra-island leg; the
last lines then give the islands and the leg's state.

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 --elastic \\
        elastic_train.py [steps] --device cpu

Checkpoint directory: ``MPI4JAX_TPU_CKPT_DIR``.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch.elastic import current_generation  # noqa: E402
from mpi4jax_tpu_torch.elastic import training  # noqa: E402
from mpi4jax_tpu_torch.ops import _collectives as coll  # noqa: E402
from mpi4jax_tpu_torch.ops import flash  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402
from mpi4jax_tpu_torch.topo import _ici_leg  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")
SUM_TERM = "--sum-term" in sys.argv
STEPS = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
    else 12


def grad(step, dev):
    return torch.cos(torch.arange(8, dtype=torch.float64, device=dev)
                     * (step + 1) * 0.1)


def step_fn(state, step, comm):
    g = mt.allreduce(grad(step, state.device), op=mt.MAX, comm=comm)
    if SUM_TERM:
        mine = grad(step, state.device).float().repeat(8)
        if comm.rank() != 0:
            mine = torch.zeros_like(mine)
        g = g + mt.allreduce(mine, op=mt.SUM, comm=comm)[:8].double()
    return state - 0.05 * g


def main():
    comm = get_world_comm(device=DEVICE)
    state = training.run(step_fn, torch.zeros(8, dtype=torch.float64,
                                              device=comm.device),
                         steps=STEPS, save_every=2, comm=comm)
    digest = hashlib.sha256(state.cpu().numpy().tobytes()).hexdigest()
    rank = comm.rank()
    launches = dict(coll.LAUNCHES, **flash.LAUNCHES)
    # one write per line: the ranks share the launcher's stdout
    sys.stdout.write(f"elastic_train digest r{rank} {digest}\n")
    sys.stdout.write("elastic_train launches " + json.dumps(
        {"rank": rank, "size": comm.size(),
         "generation": current_generation(), "launches": launches}) + "\n")
    if SUM_TERM:
        t = comm.topology()
        sys.stdout.write("elastic_train islands " + json.dumps(
            {"rank": rank, "islands": t.islands if t else None,
             "leg": _ici_leg.ici_leg_status(comm.handle)["active"],
             "fold_s": _ici_leg.PHASE_SECONDS["fold"]}) + "\n")
    sys.stdout.write("elastic_train OK\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
