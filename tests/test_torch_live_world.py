"""Live re-tuning on the CPU world: a mid-run swap, launched.

The port's counterpart of ``tests/world/test_live_world.py``: its int32
program at np 2 (30 SUM allreduces, ``x + step``), run twice side by side
under the port's launcher with the shm arena off and
``MPI4JAX_TPU_LIVE_COOLDOWN_OPS=8``: once with ``--live`` and rank 0
proposing ``rd`` for every allreduce after call 10, once without.  Every
rank of the live run must report epoch 1 and one swap, rank 0 must log
``[live] epoch 1 committed``, and the digests must equal the live-off
run's, which reports epoch 0, no swap and no boundary hook (int32 SUM is
exact under every schedule, so a swap that changed a bit would be a
dispatch fault).
"""

import os
import re
import subprocess
import sys

import pytest

from mpi4jax_tpu_torch.runtime import bridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROG = r"""
import hashlib, sys
sys.path.insert(0, %r)
import numpy as np
import torch
import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch import live
from mpi4jax_tpu_torch.runtime import bridge
from mpi4jax_tpu_torch.runtime.transport import get_world_comm

torch.set_num_threads(1)
comm = get_world_comm(device="cpu")
rank, size = comm.rank(), comm.size()
dig = hashlib.sha256()
x = torch.from_numpy((np.arange(4096, dtype=np.int32) %% 977) + 1)
for step in range(30):
    out = mt.allreduce(x + step, comm=comm)
    assert int(out[0]) == (int(x[0]) + step) * size, (step, out[0])
    dig.update(out.numpy().tobytes())
    if step == 9 and rank == 0 and live.armed():
        live.propose({"allreduce": [(0, "rd")]}, note="world-test")
st = live.status()
hook = bridge._live_boundary is not None
print("live_swap rank %%d epoch %%d swaps %%d hook %%d digest %%s"
      %% (rank, st.get("epoch", 0), len(st.get("swaps", [])), hook,
          dig.hexdigest()), flush=True)
comm.finalize()
assert bridge._live_boundary is None
"""

LINE = re.compile(r"live_swap rank (\d+) epoch (\d+) swaps (\d+) hook (\d) "
                  r"digest ([0-9a-f]{64})")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("live_world")
    bridge.build()
    prog = tmp / "prog.py"
    prog.write_text(PROG % REPO)
    env = dict(os.environ, PYTHONPATH=REPO, MPI4JAX_TPU_DISABLE_SHM="1",
               MPI4JAX_TPU_LIVE_COOLDOWN_OPS="8")
    env.pop("MPI4JAX_TPU_LIVE", None)
    procs = {}
    for name, flags in (("live", ["--live"]), ("off", [])):
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch", "-n",
             "2", "--timeout", "150", *flags, str(prog)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=200)
        assert p.returncode == 0, (name, stderr[-3000:])
        rows = {int(r): (int(e), int(s), int(k), d)
                for r, e, s, k, d in LINE.findall(stdout)}
        assert sorted(rows) == [0, 1], stdout
        out[name] = (rows, stderr)
    return out


def test_mid_run_swap_commits_epoch_1_on_every_rank(runs):
    rows, stderr = runs["live"]
    assert {e for e, _, _, _ in rows.values()} == {1}
    assert all(s == 1 and k == 1 for _, s, k, _ in rows.values())
    assert "[live] epoch 1 committed" in stderr, stderr[-2000:]


def test_swapped_run_is_bit_for_bit_the_live_off_run(runs):
    live_rows, _ = runs["live"]
    off_rows, _ = runs["off"]
    digests = {d for _, _, _, d in live_rows.values()}
    assert len(digests) == 1
    assert digests == {d for _, _, _, d in off_rows.values()}
    # live off: epoch 0, no swap, no boundary hook
    assert all(e == 0 and s == 0 and k == 0
               for e, s, k, _ in off_rows.values())
