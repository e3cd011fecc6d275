"""Plan execution on the CPU world: plan on against plan off, launched.

The port's counterpart of ``tests/world/test_plan_runtime.py``: six jobs
of the port's launcher (``--device cpu``), started side by side by one
fixture once the analyzer (in-process) has emitted the two plans:

- the chain of ``benchmarks.schedule_overlap`` at np 3 (the shm arena off,
  as the JAX bridge-level test runs): every block equal to its numpy
  oracle and each rank's digest the same with the plan off and on (the
  program checks both), hoisted receives and deferred sends counted, no
  mismatch;
- ``false_serialization.py`` at np 3 under its emitted plan, with
  ``MPI4JAX_TPU_PLAN=0``, and through ``launch --plan``: equal digests, and
  the launcher's ``--plan: verified plan``;
- a hang injected on rank 1's second send, inside a concurrency group (a
  deferred posted send), with ``MPI4JAX_TPU_TIMEOUT_S=6``: the transport's
  deadline still ends the job;
- ``bucketed_dp_grad.py`` at np 2 under its emitted plan.
"""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from mpi4jax_tpu_torch.analysis import _cli
from mpi4jax_tpu_torch.runtime import bridge, planrt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGS = os.path.join(REPO, "tests", "torch_world_programs")
CPU = ["--device", "cpu"]


def _digests(stdout, marker):
    return sorted(re.findall(marker + r" (r\d+ [0-9a-f]{64})", stdout))


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plan_world")
    bridge.build()  # once, before the ranks look for it
    fs = os.path.join(PROGS, "false_serialization.py")
    bucketed = os.path.join(PROGS, "bucketed_dp_grad.py")
    plans = {}
    for name, prog, np_ in (("fs", fs, 3), ("bucketed", bucketed, 2)):
        plans[name] = str(tmp / f"{name}.plan.json")
        assert _cli.main([prog, "--np", str(np_), "--emit-plan",
                          plans[name], "--"] + CPU) == 0
    launch = [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch"]
    base = dict(os.environ, PYTHONPATH=REPO)
    base.pop("MPI4JAX_TPU_PLAN", None)
    specs = {
        "chain": (launch + ["-n", "3", "--timeout", "150", "-m",
                            "mpi4jax_tpu_torch.benchmarks.schedule_overlap",
                            "--", "--device", "cpu", "--rounds", "4",
                            "--block-kb", "512", "--grads", "16"],
                  {"MPI4JAX_TPU_DISABLE_SHM": "1"}),
        "fs_plan": (launch + ["-n", "3", "--timeout", "150", fs] + CPU,
                    {"MPI4JAX_TPU_PLAN": plans["fs"]}),
        "fs_off": (launch + ["-n", "3", "--timeout", "150", fs] + CPU,
                   {"MPI4JAX_TPU_PLAN": "0"}),
        "fs_launch_plan": (launch + ["-n", "3", "--timeout", "150",
                                     "--plan", fs] + CPU, {}),
        "hang": (launch + ["-n", "3", "--timeout", "120", fs] + CPU,
                 {"MPI4JAX_TPU_PLAN": plans["fs"],
                  "MPI4JAX_TPU_FAULT":
                      "rank=1,point=send,after=1,action=hang",
                  "MPI4JAX_TPU_TIMEOUT_S": "6"}),
        "bucketed": (launch + ["-n", "2", "--timeout", "150", bucketed]
                     + CPU, {"MPI4JAX_TPU_PLAN": plans["bucketed"]}),
    }
    procs = {}
    for name, (cmd, env) in specs.items():
        out = open(tmp / f"{name}.out", "w")
        err = open(tmp / f"{name}.err", "w")
        procs[name] = (subprocess.Popen(cmd, env=dict(base, **env), cwd=REPO,
                                        stdout=out, stderr=err), out, err)
    deadline = time.time() + 200
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


def test_chain_plan_on_and_off_agree_with_numpy(jobs):
    rc, out, err = jobs["chain"]
    assert rc == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    # the ranks held every block to its oracle and the digests on to off
    assert rec["digests_equal"] and rec["ranks"] == 3
    assert rec["runner"]["hoisted_recvs"] > 0
    assert rec["runner"]["deferred_sends"] > 0
    assert rec["runner"]["mismatches"] == 0
    # rank 0 only sends, rank 2 only receives
    assert rec["runner_by_rank"][0][0] == 0 and rec["runner_by_rank"][2][1] \
        == 0
    assert "plan execution disabled" not in err


def test_false_serialization_plan_equals_plan_off(jobs):
    runs = {k: jobs[k] for k in ("fs_plan", "fs_off", "fs_launch_plan")}
    for name, (rc, out, err) in runs.items():
        assert rc == 0, (name, err[-3000:])
        assert out.count("false_serialization OK") == 3
        assert "plan execution disabled" not in err, name
    d = {k: _digests(v[1], "false_serialization digest")
         for k, v in runs.items()}
    assert len(d["fs_off"]) == 3
    assert d["fs_plan"] == d["fs_off"] == d["fs_launch_plan"]


def test_launch_plan_installs_a_verified_plan(jobs):
    rc, out, err = jobs["fs_launch_plan"]
    assert rc == 0
    assert "--plan: verified plan" in err, err[-2000:]


def test_hang_inside_a_concurrency_group_still_ends_the_job(jobs):
    rc, out, err = jobs["hang"]
    assert rc != 0
    assert "timed out" in err or "deadline" in err or "rank 1" in err, \
        err[-2000:]
    assert out.count("false_serialization OK") < 3


def test_bucketed_dp_grad_runs_under_its_plan(jobs):
    rc, out, err = jobs["bucketed"]
    assert rc == 0, err[-3000:]
    assert out.count("bucketed_dp_grad OK") == 2
    assert "plan execution disabled" not in err


def test_plans_off_leave_no_runner_and_no_hook():
    """This process has neither MPI4JAX_TPU_PLAN nor MPI4JAX_TPU_LIVE: no
    runner, no boundary hook."""
    assert not os.environ.get("MPI4JAX_TPU_PLAN")
    assert not planrt.active() and planrt._runners == {}
    assert bridge._live_boundary is None
