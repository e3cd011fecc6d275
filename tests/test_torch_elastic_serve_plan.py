"""Launched elastic worlds on the CPU: the twins of
``tests/world/test_elastic.py``'s plan and serving tests.

The jobs run as in ``tests/test_torch_elastic_world.py`` (``--elastic``, the
shm arena off, short deadlines) and start together.

- ``elastic_plan.py`` at np 3: every step's allreduces run under a proved
  plan installed through the API, with ``planrt.set_plan_source``.  With
  rank 1 killed mid-job, ``bridge.rebuild`` derives and proves the plan
  again for np 2 (``planrt.reinstall_after_rebuild``): both survivors
  finish with the plan active, no mismatch and the clean run's digest.
- ``elastic_plan_bundle.py`` under ``launch --plan --elastic``: the
  launcher's bundle covers np 3 and 2, ``comm_init`` installs the np 3 plan
  and the recovery re-proves the bundle's np 2 plan; the digest equals the
  clean run's, and ``elastic_plan.py``'s (the same steps).
- ``elastic_serve.py``: a worker's death re-batches the in-flight
  requests; every request completes with the uninterrupted transcripts.
- ``serve_frontend_death.py``: the frontend's death releases the survivors
  (one promoted worker raises after its STOP, the other returns).
"""

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
PLAN_FAULT = "rank=1,point=send,after=30,action=exit"


def _job(tmp, name, prog, *args, fault=None, flags=()):
    port = _free_port_block(13)
    env = dict(os.environ, **BASE_ENV)
    env["MPI4JAX_TPU_CKPT_DIR"] = str(tmp / f"ck_{name}")
    env.pop("MPI4JAX_TPU_FAULT", None)
    env.pop("MPI4JAX_TPU_PLAN", None)
    if fault:
        env["MPI4JAX_TPU_FAULT"] = fault
    return subprocess.Popen(
        LAUNCH + ["-n", "3", "--port", str(port), "--timeout", "150",
                  "--elastic", *flags, os.path.join(PROGRAMS, prog),
                  *map(str, args)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_serve_plan")
    dev = ("--device", "cpu")
    procs = {
        "plan_clean": _job(tmp, "pc", "elastic_plan.py", 10, *dev),
        "plan": _job(tmp, "pf", "elastic_plan.py", 10, *dev,
                     fault=PLAN_FAULT),
        "bundle_clean": _job(tmp, "bc", "elastic_plan_bundle.py", 10, *dev,
                             flags=("--plan",)),
        "bundle": _job(tmp, "bf", "elastic_plan_bundle.py", 10, *dev,
                       fault=PLAN_FAULT, flags=("--plan",)),
        "serve_clean": _job(tmp, "sc", "elastic_serve.py", 10),
        "serve": _job(tmp, "sf", "elastic_serve.py", 10,
                      fault="rank=1,point=recv,after=9,action=exit"),
        "frontend": _job(tmp, "fd", "serve_frontend_death.py",
                         fault="rank=0,point=send,after=12,action=exit"),
    }
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=240)
        out[name] = (proc.returncode, stdout, stderr)
    return out


def _digests(stdout, marker):
    return sorted(set(re.findall(marker + r" (?:r\d+ )?([0-9a-f]{64})",
                                 stdout)))


def _ok(run):
    rc, stdout, stderr = run
    assert rc == 0, stdout[-1500:] + stderr[-2500:]
    return stdout, stderr


def test_shrink_reproves_and_keeps_the_plan(runs):
    clean, _ = _ok(runs["plan_clean"])
    assert clean.count("elastic_plan OK np=3 plan_active=1") == 3
    d_clean = _digests(clean, "elastic_plan digest")
    assert len(d_clean) == 1
    stdout, stderr = _ok(runs["plan"])
    assert stdout.count("elastic_plan OK") == 2
    assert stdout.count("np=2 plan_active=1 mismatches=0") == 2, stdout
    # re-derived and proved again for the new size, not the np 3 plan
    assert stderr.count("re-proved plan") == 2, stderr[-2000:]
    assert "for the recovered np=2 world" in stderr
    assert "overlap preserved across recovery" in stderr
    assert "completed after recovery" in stderr
    assert _digests(stdout, "elastic_plan digest") == d_clean


def test_plan_bundle_reproves_after_shrink(runs):
    clean, clean_err = _ok(runs["bundle_clean"])
    assert "plan bundle covers np=[2, 3]" in clean_err
    assert clean.count("np=3 plan_active=1 mismatches=0") == 3, clean
    d_clean = _digests(clean, "elastic_plan_bundle digest")
    assert len(d_clean) == 1
    # the same steps as elastic_plan.py, so the same state
    assert d_clean == _digests(_ok(runs["plan_clean"])[0],
                               "elastic_plan digest")
    stdout, stderr = _ok(runs["bundle"])
    assert "plan bundle covers np=[2, 3]" in stderr
    assert stdout.count("np=2 plan_active=1 mismatches=0") == 2, stdout
    assert stderr.count("re-proved plan") == 2, stderr[-2000:]
    assert "for the recovered np=2 world" in stderr
    assert "plan execution disabled" not in stderr
    assert _digests(stdout, "elastic_plan_bundle digest") == d_clean


def test_serving_survives_a_workers_death(runs):
    clean, _ = _ok(runs["serve_clean"])
    assert "elastic_serve OK nreq=10 recoveries=0" in clean
    stdout, stderr = _ok(runs["serve"])
    assert "elastic_serve OK nreq=10 recoveries=1" in stdout, stdout
    assert _digests(stdout, "elastic_serve digest") == \
        _digests(clean, "elastic_serve digest")
    assert "retrying" in stderr


def test_frontend_death_releases_the_survivors(runs):
    stdout, stderr = _ok(runs["frontend"])
    assert stdout.count("fd promoted clean") == 1, stdout
    assert stdout.count("fd worker done") == 1, stdout
    assert "fault did not fire" not in stdout
