"""Launched elastic worlds on the CPU: the twins of
``tests/world/test_elastic.py:62-304`` for training, failure and topology.

Every job runs under the port's launcher with ``--elastic``, the shm arena
off (the fault points of ``MPI4JAX_TPU_FAULT`` are then the TCP ones, as in
the JAX tests), ``MPI4JAX_TPU_TIMEOUT_S=20`` (a deadline only a stalled
peer meets: a death resets its sockets) and
``MPI4JAX_TPU_ELASTIC_GRACE_S=20``; the jobs of this file start together.

- ``elastic_train.py`` at np 3 (12 steps, a commit every 2): uninterrupted;
  with rank 1 killed mid-job under ``shrink`` (and ``--trace``) and under
  ``respawn``.  Every finishing rank's digest equals the clean run's, bit
  for bit; the post-mortem says what the recovery cost and where it resumed
  (0 < step < 12); the two survivors' trace parts, the merged trace and the
  checkpoint manifests written after the recovery carry generation 1.
- A rank that catches ``RankFailure`` itself: the fault fires in topology
  discovery, the first collective of the comm's creation, and must surface
  as the exception, with ``op=``, not as a flat comm with a warning.
- np 4 on ``r0,r1|r2,r3`` with the leg forced (``--sum-term``: a float32
  SUM allreduce on ``hring`` every step) loses slot 1 and finishes on the
  islands ``{0,1}|{2}`` with the leg active and the clean run's digest.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from mpi4jax_tpu_torch.runtime.transport import _free_port_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = os.path.join(REPO, "tests", "torch_world_programs")
LAUNCH = [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch"]
BASE_ENV = {"MPI4JAX_TPU_DISABLE_SHM": "1", "MPI4JAX_TPU_TIMEOUT_S": "20",
            "MPI4JAX_TPU_ELASTIC_GRACE_S": "20"}
FAULT = "rank=1,point=send,after=14,action=exit"
ISLANDS = {"MPI4JAX_TPU_ICI_LEG": "force",
           "MPI4JAX_TPU_COLL_ALGO": "allreduce=hring"}

CATCH = """
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from mpi4jax_tpu_torch.elastic import RankFailure
from mpi4jax_tpu_torch.runtime import bridge, transport
c = transport.get_world_comm(device="cpu")
if c.rank() == 0:
    try:
        h = c.handle  # comm_init: the fault fires in discovery's allgather
        bridge.recv(h, np.zeros(4), 1, 7)
        print("UNREACHABLE", flush=True)
    except RankFailure as e:
        print(f"caught RankFailure op={{e.op}}", flush=True)
    # stay up while the launcher sees rank 1's death
    time.sleep(2)
else:
    h = c.handle
"""


def _job(tmp, name, np_, prog, *prog_args, env=None, flags=()):
    port = _free_port_block(4 * (np_ + 1))
    full_env = dict(os.environ, **BASE_ENV)
    full_env["MPI4JAX_TPU_CKPT_DIR"] = str(tmp / f"ck_{name}")
    full_env.pop("MPI4JAX_TPU_FAULT", None)
    full_env.update(env or {})
    return subprocess.Popen(
        LAUNCH + ["-n", str(np_), "--port", str(port), "--timeout", "150",
                  "--elastic", *flags, prog, *map(str, prog_args)],
        env=full_env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_world")
    train = os.path.join(PROGRAMS, "elastic_train.py")
    catch = tmp / "catch.py"
    catch.write_text(CATCH.format(repo=REPO))
    trace = tmp / "trace.json"
    procs = {
        "clean": _job(tmp, "clean", 3, train, 12, "--device", "cpu"),
        # the recorder's clock handshake adds sends ahead of the steps
        "shrink": _job(tmp, "shrink", 3, train, 12, "--device", "cpu",
                       env={"MPI4JAX_TPU_FAULT": FAULT.replace("14", "22")},
                       flags=("--trace", str(trace))),
        "respawn": _job(tmp, "respawn", 3, train, 12, "--device", "cpu",
                        env={"MPI4JAX_TPU_FAULT": FAULT},
                        flags=("--elastic-policy", "respawn")),
        "catch": _job(tmp, "catch", 2, str(catch), env={
            "MPI4JAX_TPU_FAULT": "rank=1,point=recv,after=0,action=exit",
            "MPI4JAX_TPU_TIMEOUT_S": "6"}),
        "islands_clean": _job(
            tmp, "islands_clean", 4, train, 12, "--device", "cpu",
            "--sum-term", env=ISLANDS,
            flags=("--fake-hosts", "r0,r1|r2,r3")),
        "islands": _job(
            tmp, "islands", 4, train, 12, "--device", "cpu", "--sum-term",
            env=dict(ISLANDS, MPI4JAX_TPU_FAULT=FAULT.replace("14", "40")),
            flags=("--fake-hosts", "r0,r1|r2,r3")),
    }
    out = {"tmp": tmp, "trace": trace}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        out[name] = (proc.returncode, stdout, stderr)
    return out


def _digests(stdout, marker="elastic_train digest"):
    return sorted(set(re.findall(marker + r" r\d+ ([0-9a-f]{64})", stdout)))


def _ok(run, n):
    rc, stdout, stderr = run
    assert rc == 0, stderr[-2500:]
    assert stdout.count("elastic_train OK") == n, stdout
    return stdout, stderr


def _resumed(stderr):
    return [int(s) for s in re.findall(r"resuming from step (\d+)", stderr)]


def test_shrink_recovery_matches_the_uninterrupted_run(runs):
    clean, _ = _ok(runs["clean"], 3)
    d_clean = _digests(clean)
    assert len(d_clean) == 1
    stdout, stderr = _ok(runs["shrink"], 2)
    assert _digests(stdout) == d_clean
    assert "completed after recovery" in stderr
    assert "(policy shrink): reached generation 1" in stderr
    assert "lost rank slot(s) [1]" in stderr
    assert re.search(r"resumed from step \d+", stderr)
    assert _resumed(stderr) and all(0 < k < 12 for k in _resumed(stderr))
    assert stderr.count("recovered into generation 1 as rank") == 2
    # the launches line of each survivor: the new world and its generation
    lines = [json.loads(m) for m in re.findall(
        r"elastic_train launches (\{.*\})", stdout)]
    assert sorted((d["rank"], d["size"], d["generation"]) for d in lines) \
        == [(0, 2, 1), (1, 2, 1)]


def test_respawn_recovery_all_ranks_finish(runs):
    d_clean = _digests(_ok(runs["clean"], 3)[0])
    stdout, stderr = _ok(runs["respawn"], 3)
    assert _digests(stdout) == d_clean
    assert "policy respawn" in stderr
    assert "completed after recovery" in stderr
    assert "(respawned)" in stderr
    assert "lost rank slot(s)" not in stderr


def test_rank_failure_surfaces_from_topology_discovery(runs):
    rc, stdout, stderr = runs["catch"]
    assert rc == 0, stderr[-1500:]
    m = re.search(r"caught RankFailure op=(\w+)", stdout)
    assert m and m.group(1) == "Allgather", stdout
    assert "UNREACHABLE" not in stdout
    # not softened into a flat comm
    assert "topology discovery failed" not in stderr


def test_recordings_and_manifests_carry_the_generation(runs):
    _ok(runs["shrink"], 2)
    tmp, trace = runs["tmp"], runs["trace"]
    parts = sorted(tmp.glob("trace.json.rank*.json"))
    assert len(parts) == 2, parts  # the two survivors dumped
    assert {json.loads(p.read_text())["generation"] for p in parts} == {1}
    merged = json.loads(trace.read_text())
    assert set(merged["otherData"]["generations"].values()) == {1}
    ck = tmp / "ck_shrink"
    gens = {}
    for step in sorted(os.listdir(ck)):
        with open(ck / step / "manifest.json") as f:
            m = json.load(f)
        gens[m["step"]] = (m["generation"], m["nshards"])
    # the last three commits (keep=3) were written after the recovery
    assert gens and all(v == (1, 2) for v in gens.values()), gens
    assert max(gens) == 12


def test_shrink_on_two_islands_keeps_the_leg(runs):
    clean, _ = _ok(runs["islands_clean"], 4)
    d_clean = _digests(clean)
    assert len(d_clean) == 1
    stdout, stderr = _ok(runs["islands"], 3)
    assert _digests(stdout) == d_clean
    assert _resumed(stderr) and all(0 < k < 12 for k in _resumed(stderr))
    islands = [json.loads(m) for m in re.findall(
        r"elastic_train islands (\{.*\})", stdout)]
    assert len(islands) == 3
    for d in islands:
        assert d["islands"] == [[0, 1], [2]]
        assert d["leg"] is True and d["fold_s"] > 0
