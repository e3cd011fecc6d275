"""Elastic and planned training: the torch twin of
``tests/world_programs/elastic_plan.py``.

Every step runs K small MAX allreduces (the port's staged world ops) under
an installed, proved execution plan: adjacent small allreduces are what the
compiler marks as a gradient bucket, so the plan is rewritten, and the
runner checks every op's signature.  ``planrt.set_plan_source`` tells a
recovery how to derive the schedule at any world size, so when a rank dies
``bridge.rebuild`` compiles and proves the plan again for the shrunk world
and the job keeps it.  The MAX sync does not depend on the world size, so
the final digest must equal an uninterrupted planned run's.

    python -m mpi4jax_tpu_torch.runtime.launch -n 3 --elastic \\
        elastic_plan.py [steps] --device cpu

Checkpoint directory: ``MPI4JAX_TPU_CKPT_DIR``.
"""

import hashlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import torch  # noqa: E402

import mpi4jax_tpu_torch as mt  # noqa: E402
from mpi4jax_tpu_torch.analysis import _events, _plan  # noqa: E402
from mpi4jax_tpu_torch.elastic import training  # noqa: E402
from mpi4jax_tpu_torch.runtime import planrt  # noqa: E402
from mpi4jax_tpu_torch.runtime.transport import get_world_comm  # noqa: E402

DEVICE = (sys.argv[sys.argv.index("--device") + 1]
          if "--device" in sys.argv else "cuda")
STEPS = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() \
    else 10
K = 4               # planned allreduces a step (one cycle of the plan)
SHAPE = (256,)      # f64: 2 KB, bucketable, so the plan is rewritten


def make_schedule(n):
    """The schedule of a step at any world size: K adjacent small MAX
    allreduces a rank."""
    events = {
        r: [_events.CommEvent(r, i, "allreduce", reduce_op="MAX",
                              dtype="float64", shape=SHAPE)
            for i in range(K)]
        for r in range(n)
    }
    return events, {(0,): tuple(range(n))}


# how a recovery derives the plan of a shrunk world: rebuild calls this
# with the new size and proves the compiled plan before it runs
planrt.set_plan_source(make_schedule)


def grad(step, j, dev):
    # the same on every rank and MAX-synced: bit for bit at any size
    return torch.cos(torch.arange(SHAPE[0], dtype=torch.float64, device=dev)
                     * (step + 1) * 0.01 * (j + 1))


def step_fn(state, step, comm):
    rt = planrt.get(comm)
    assert rt is not None and rt.enabled, \
        f"step {step}: no active plan runner on this world"
    g = torch.zeros(8, dtype=torch.float64, device=state.device)
    for j in range(K):
        g = g + mt.allreduce(grad(step, j, state.device), op=mt.MAX,
                             comm=comm)[:8]
    assert rt.stats["mismatches"] == 0, rt.stats
    return state - 0.05 * g


def main():
    comm = get_world_comm(device=DEVICE)
    n, r = comm.size(), comm.rank()
    plan = _plan.compile_schedules(*make_schedule(n))
    assert plan.proved, plan.reasons
    assert plan.rewritten, plan.format()  # bucket marks
    assert planrt.install(comm.handle, plan, r,
                          pin_memory=comm.device.type == "cuda"), \
        "planrt.install refused"

    state = training.run(step_fn, torch.zeros(8, dtype=torch.float64,
                                              device=comm.device),
                         steps=STEPS, save_every=2, comm=comm)

    rt = planrt.get(comm)
    assert rt is not None and rt.enabled, "plan lost by the end of the job"
    assert rt.stats["mismatches"] == 0, rt.stats
    rt.flush()
    digest = hashlib.sha256(state.cpu().numpy().tobytes()).hexdigest()
    sys.stdout.write(f"elastic_plan digest r{comm.rank()} {digest}\n")
    sys.stdout.write(f"elastic_plan OK np={comm.size()} plan_active=1 "
                     "mismatches=0\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
