"""Plan execution on a world of two islands keeps the intra-island leg off.

A plan's proof covers the world ops its analyzer saw; the leg's sub-comm
allgather, leader exchange and bcast are not among them, so the leg's
eligibility (``topo/_ici_leg.eligible``) refuses it whenever
``MPI4JAX_TPU_PLAN`` is set, as the JAX package's does.  Three CPU jobs of
``tests/torch_world_programs/plan_islands.py`` at np 4 on
``--fake-hosts 'r0,r1|r2,r3'``, started side by side:

- ``launch --plan`` with ``MPI4JAX_TPU_ICI_LEG=force``: a verified plan is
  installed on every rank and no phase of the leg runs;
- ``MPI4JAX_TPU_PLAN=0`` with the leg off: the digests the planned job
  must equal (the native ``hring`` it runs);
- ``MPI4JAX_TPU_PLAN=0`` with the leg forced: the leg runs, so the planned
  job's leg is off because of the plan.
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from mpi4jax_tpu_torch.runtime import bridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROG = os.path.join(REPO, "tests", "torch_world_programs", "plan_islands.py")


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plan_islands")
    bridge.build()  # once, before the ranks look for it
    launch = [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch",
              "-n", "4", "--fake-hosts", "r0,r1|r2,r3", "--timeout", "120"]
    base = dict(os.environ, PYTHONPATH=REPO)
    base.pop("MPI4JAX_TPU_PLAN", None)
    specs = {
        "plan": (launch + ["--plan", PROG, "--device", "cpu"],
                 {"MPI4JAX_TPU_ICI_LEG": "force"}),
        "off": (launch + [PROG, "--device", "cpu"],
                {"MPI4JAX_TPU_PLAN": "0", "MPI4JAX_TPU_ICI_LEG": "off"}),
        "leg": (launch + [PROG, "--device", "cpu"],
                {"MPI4JAX_TPU_PLAN": "0", "MPI4JAX_TPU_ICI_LEG": "force"}),
    }
    procs = {}
    for name, (cmd, env) in specs.items():
        out = open(tmp / f"{name}.out", "w")
        err = open(tmp / f"{name}.err", "w")
        procs[name] = (subprocess.Popen(cmd, env=dict(base, **env), cwd=REPO,
                                        stdout=out, stderr=err), out, err)
    deadline = time.time() + 150
    res = {}
    for name, (p, out, err) in procs.items():
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        out.close()
        err.close()
        res[name] = (rc, (tmp / f"{name}.out").read_text(),
                     (tmp / f"{name}.err").read_text())
    return res


def _states(out):
    return sorted((json.loads(s) for s in
                   re.findall(r"plan_islands state (\{.*\})", out)),
                  key=lambda s: s["rank"])


def _digests(out):
    return sorted(re.findall(r"plan_islands digest (r\d+ [0-9a-f]{64})",
                             out))


def test_launch_plan_keeps_the_leg_off(jobs):
    rc, out, err = jobs["plan"]
    assert rc == 0, err[-3000:]
    assert "--plan: verified plan" in err, err[-2000:]
    assert "plan execution disabled" not in err
    states = _states(out)
    assert [s["rank"] for s in states] == [0, 1, 2, 3]
    assert all(s["plan"] and not s["leg_ran"] for s in states), states


def test_planned_digests_equal_the_plan_off_run(jobs):
    for name in ("plan", "off"):
        assert jobs[name][0] == 0, (name, jobs[name][2][-3000:])
    want = _digests(jobs["off"][1])
    assert len(want) == 4
    assert _digests(jobs["plan"][1]) == want


def test_without_a_plan_the_forced_leg_runs(jobs):
    rc, out, err = jobs["leg"]
    assert rc == 0, err[-3000:]
    states = _states(out)
    assert len(states) == 4
    assert all(not s["plan"] and s["leg_ran"] for s in states), states
    assert not any(s["leg_ran"] for s in _states(jobs["off"][1]))
