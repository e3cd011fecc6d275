"""Plan execution and live re-tuning on the card (marked ``gpu``; they skip
without one).  This file imports no JAX, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_planlive_gpu.py

- the receive-buffer hazard: a 2-rank chain of 60 rounds on ``cuda:0``
  under its plan, each receive pre-posted while the card is still busy with
  a kernel queued ahead of the previous result's copy to the card, and a
  kernel reading every result; each result must equal its oracle (a
  pre-post buffer recycled before its copy ran would carry the next
  round's bytes);
- live re-tuning onto the leg: ``benchmarks.live_world`` at 1 MiB a rank
  (np 4 on ``r0,r1|r2,r3``, the smallest layout with two-member islands
  on two hosts: at np 2 no island has two members, so the leg launches no
  kernel 3): epoch 1 on every rank, one swap at one boundary, every call bit
  for bit its simulator, kernel 3 once per rank per call after the commit
  and never before.
"""

import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HAZARD = r"""
import sys
sys.path.insert(0, %r)
import numpy as np
import torch
import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.analysis import _events, _plan
from mpi4jax_tpu_torch.runtime import planrt
from mpi4jax_tpu_torch.runtime.transport import get_world_comm

ROUNDS, N = 60, 256 * 1024
comm = get_world_comm(device="cuda")
rank, size = comm.rank(), comm.size()
dev = comm.device
ev = _events.CommEvent
events = {0: [ev(0, k, "send", dest=1, tag=k, dtype="float32", shape=(N,))
              for k in range(ROUNDS)],
          1: [ev(1, k, "recv", source=0, tag=k, dtype="float32", shape=(N,))
              for k in range(ROUNDS)]}
plan = _plan.compile_schedules(events, {(0,): (0, 1)})
assert plan.proved and plan.rewritten, plan.reasons
mt.barrier(comm=comm)
assert planrt.install(comm.handle, plan, rank, pin_memory=True)
rt = planrt.get(comm)
base = torch.arange(N, dtype=torch.float32, device=dev)
outs = []
for k in range(ROUNDS):
    if rank == 0:
        mt.send(base + k, dest=1, tag=k, comm=comm)
    else:
        # the card stays busy, so this round's copy to the card runs late,
        # while the next receive is already posted
        torch.cuda._sleep(2_000_000)
        got = mt.recv(torch.empty(N, device=dev), source=0, tag=k,
                      comm=comm)
        outs.append(got * 1.0)  # a kernel reading the result
torch.cuda.synchronize(dev)
stats = dict(rt.stats)
planrt.detach(comm.handle)
mt.barrier(comm=comm)
if rank == 1:
    ref = np.arange(N, dtype=np.float32)
    for k, o in enumerate(outs):
        assert np.array_equal(o.cpu().numpy(), ref + k), f"round {k}"
    assert stats["hoisted_recvs"] >= ROUNDS - 1, stats
else:
    assert stats["deferred_sends"] == ROUNDS, stats
assert stats["mismatches"] == 0, stats
print(f"hazard OK rank {rank} {stats}", flush=True)
comm.finalize()
"""


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def test_recv_buffer_is_not_reused_before_its_copy(dev, tmp_path):
    prog = tmp_path / "hazard.py"
    prog.write_text(HAZARD % REPO)
    env = dict(os.environ, PYTHONPATH=REPO, MPI4JAX_TPU_DISABLE_SHM="1")
    env.pop("MPI4JAX_TPU_PLAN", None)
    res = subprocess.run(
        [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch", "-n", "2",
         "--timeout", "240", str(prog)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("hazard OK") == 2, res.stdout


def test_live_swap_moves_the_allreduce_onto_the_leg(dev):
    from mpi4jax_tpu_torch.benchmarks import live_world

    rec = live_world.run_job(live=True, device="cuda", mib=1, timeout=300)
    n, commit = rec["ranks"], rec["commit_call"]
    assert rec["epochs"] == [1] * n and rec["swaps"] == [1] * n
    assert len(set(rec["commit_boundaries"])) == 1
    assert commit is not None and commit >= rec["propose_after"]
    assert rec["schedules"] == ["ring"] * commit \
        + ["hring"] * (rec["calls"] - commit)
    assert rec["launches"] == [0] * commit + [1] * (rec["calls"] - commit)
    assert rec["launches_by_rank"] == [rec["calls"] - commit] * n
