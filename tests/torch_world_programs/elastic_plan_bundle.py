"""Elastic and planned, with the plan from ``launch --plan --elastic``.

The schedule of ``elastic_plan.py`` (K small MAX allreduces a step, the
port's staged world ops, a rewritten plan of gradient buckets), but the
plan is the launcher's: the analyzer runs this program at np and at every
size down to 2, and the ranks get the bundle through ``MPI4JAX_TPU_PLAN``.
``comm_init`` installs the plan of the starting size, and after a rank's
death ``bridge.rebuild`` takes the shrunk size's plan from the bundle and
proves it again.  The program keeps its state in memory and, on a
``RankFailure``, recovers and runs the failed step again (its ops are the
plan's, in order), so the static verifier can run it: it writes no
checkpoint.  The MAX sync does not depend on the world size, so the digest
must equal an uninterrupted run's.

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 --plan --elastic \\
        elastic_plan_bundle.py [steps] --device cpu
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch import elastic  # noqa: E402
from mpi4jax_tpu_torch.runtime import planrt  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")
STEPS = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
    else 10
K = 4
SHAPE = (256,)


def grad(step, j, dev):
    return torch.cos(torch.arange(SHAPE[0], dtype=torch.float64, device=dev)
                     * (step + 1) * 0.01 * (j + 1))


def main():
    comm = get_world_comm(device=DEVICE)
    state = torch.zeros(8, dtype=torch.float64, device=comm.device)
    step = 0
    while step < STEPS:
        try:
            g = torch.zeros_like(state)
            for j in range(K):
                g = g + mt.allreduce(grad(step, j, comm.device), op=mt.MAX,
                                     comm=comm)[:8]
        except BaseException as e:
            if not elastic.is_rank_failure(e):
                raise
            elastic.recover(comm)
            continue  # the failed step again, on the new world
        state = state - 0.05 * g
        step += 1
    rt = planrt.get(comm)
    active = rt is not None and rt.enabled
    mismatches = rt.stats["mismatches"] if rt is not None else 0
    if rt is not None:
        rt.flush()
    digest = hashlib.sha256(state.cpu().numpy().tobytes()).hexdigest()
    sys.stdout.write(f"elastic_plan_bundle digest r{comm.rank()} "
                     f"{digest}\n")
    sys.stdout.write(f"elastic_plan_bundle OK np={comm.size()} "
                     f"plan_active={int(active)} mismatches={mismatches}\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
