"""The port's elastic launcher against the JAX package's, on the CPU.

- **Announcements.**  ``tests/torch_world_programs/elastic_deaths.py``
  (standard library only) kills slot 1 in generation 0 and slot 2 in
  generation 1 of a 4-rank job, and its survivors copy every ``gen_<n>.json``
  out.  Both launchers run it with ``--elastic``, the same ``--port`` and
  ``--hosts``, under each policy: the files must agree field by field, and
  so must the post-mortems.  The stops agree too: a 1-rank job whose rank
  dies has no survivor to shrink onto, and one that dies in every
  generation under ``respawn`` meets the cap of ``2 * np + 2``
  generations.
- **The ladder.**  ``launch --plan --elastic``'s pre-flight on the twin of
  ``halo_exchange.py`` at np 4 gives the bundle the JAX launcher gives for
  the JAX program: the same sizes, and each plan equal apart from its proof
  (``diff_plans``), ``cache_key`` included.
- **Schedules at shrunk sizes.**  A rank-symmetric program verifies clean at
  np 3 and at np 2 in both packages' ``analysis.check``
  (``tests/world/test_elastic.py:379``).
- The post-mortem's stderr scans (``_self_heal_outcomes``,
  ``_last_native_error``) equal the JAX launcher's on the same tails.
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch import analysis
from mpi4jax_tpu_torch.analysis import _plan
from mpi4jax_tpu_torch.runtime import launch as p_launch
from mpi4jax_tpu_torch.runtime.transport import _free_port_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEATHS = os.path.join(REPO, "tests", "torch_world_programs",
                      "elastic_deaths.py")
LAUNCHERS = {
    "jax": [sys.executable, os.path.join(REPO, "mpi4jax_tpu", "runtime",
                                         "launch.py")],
    "port": [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch"],
}
HOSTS = "127.0.0.1,127.0.0.2,127.0.0.3,127.0.0.4"
POLICIES = ("shrink", "respawn")

_spec = importlib.util.spec_from_file_location(
    "m4j_jax_launch", os.path.join(REPO, "mpi4jax_tpu", "runtime",
                                   "launch.py"))
j_launch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(j_launch)


def _post_mortem(stderr):
    return [line for line in stderr.splitlines()
            if line.startswith("launch: post-mortem")]


@pytest.fixture(scope="module")
def death_runs(tmp_path_factory):
    """Every launcher x case, started together: the 4-rank death sequence
    under both policies, and the two stops."""
    cases = {(policy, "1,2", 4): policy for policy in POLICIES}
    cases[("shrink", "0", 1)] = "alone"
    cases[("respawn", "0,0,0,0,0,0,0", 1)] = "cap"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    for (policy, deaths, np_), label in cases.items():
        # one port block per case, shared by the two launchers (the
        # programs listen on nothing: the port only enters the files)
        port = _free_port_block(1)
        hosts = ["--hosts", HOSTS] if np_ == 4 else []
        for name, launcher in LAUNCHERS.items():
            out = tmp_path_factory.mktemp(f"{name}_{label}")
            procs[name, label] = (out, subprocess.Popen(
                launcher + ["-n", str(np_), "--port", str(port), *hosts,
                            "--elastic", "--elastic-policy", policy,
                            "--timeout", "120", DEATHS, str(out), deaths],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    runs = {}
    for key, (out, proc) in procs.items():
        _, stderr = proc.communicate(timeout=180)
        files = {}
        for name in sorted(os.listdir(out)):
            if name.startswith("gen_"):
                with open(os.path.join(out, name)) as f:
                    files[name] = json.load(f)
        runs[key] = (proc.returncode, files, _post_mortem(stderr), stderr)
    return runs


@pytest.mark.parametrize("policy", POLICIES)
def test_announcements_equal_the_jax_launchers(death_runs, policy):
    rc_j, files_j, pm_j, err_j = death_runs["jax", policy]
    rc_p, files_p, pm_p, err_p = death_runs["port", policy]
    assert rc_j == rc_p == 0, (err_j[-1500:], err_p[-1500:])
    assert sorted(files_p) == ["gen_1.json", "gen_2.json"]
    assert files_p == files_j
    assert pm_p == pm_j
    gen2 = files_p["gen_2.json"]
    port = gen2["base_port"] - 2 * 5
    if policy == "shrink":
        assert gen2["map"] == {"0": 0, "3": 1, "1": -1, "2": -1}
        assert gen2["hosts"] == "127.0.0.1,127.0.0.4"
        assert gen2["lost"] == [1, 2] and gen2["size"] == 2
    else:
        assert gen2["map"] == {str(s): s for s in range(4)}
        assert gen2["hosts"] == HOSTS and gen2["lost"] == []
    assert files_p["gen_1.json"]["base_port"] == port + 5


@pytest.mark.parametrize("label,line", [
    ("alone", "no surviving rank to shrink onto"),
    ("cap", "giving up after 4 recoveries (generation cap)")])
def test_the_stops_equal_the_jax_launchers(death_runs, label, line):
    rc_j, files_j, pm_j, err_j = death_runs["jax", label]
    rc_p, files_p, pm_p, err_p = death_runs["port", label]
    assert rc_p == rc_j == 17
    assert files_p == files_j
    assert pm_p == pm_j and len(pm_p) == 1
    assert line in err_p and line in err_j


def test_the_plan_ladder_equals_the_jax_launchers(capfd):
    """``--plan --elastic``'s bundle, both launchers' pre-flights side by
    side (each runs its package's analyzer in subprocesses)."""
    paths = {}

    def port():
        paths["port"] = p_launch._preflight_plan(
            os.path.join("tests", "torch_world_programs",
                         "halo_exchange.py"), 4, ["--device", "cpu"],
            elastic=True)

    def jax():
        paths["jax"] = j_launch._preflight_plan(
            os.path.join("tests", "world_programs", "halo_exchange.py"), 4,
            [], elastic=True)

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        threads = [threading.Thread(target=f) for f in (port, jax)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        os.chdir(cwd)
    try:
        assert paths["port"][0] == paths["jax"][0] == 0
        with open(paths["port"][1]) as f:
            raw = json.load(f)
        assert raw["format"] == "plan-bundle" and raw["version"] == 1
        got = _plan.load_bundle(paths["port"][1])
        want = _plan.load_bundle(paths["jax"][1])
        assert sorted(got) == sorted(want) == [3, 4]
        for n in got:
            assert got[n].proved and got[n].rewritten
            assert got[n].cache_key == want[n].cache_key
            assert _plan.diff_plans(want[n], got[n]) == ""
    finally:
        for _, path in paths.values():
            if path:
                os.unlink(path)
    err = capfd.readouterr().err
    assert err.count("plan bundle covers np=[3, 4]") == 2
    assert err.count("no plan for np=2") == 2


def test_schedules_stay_valid_at_shrunk_sizes():
    import jax.numpy as jnp

    import mpi4jax_tpu as m4j
    from mpi4jax_tpu import analysis as j_analysis

    def j_program(x):
        return m4j.allgather(m4j.allreduce(x, op=m4j.SUM))

    def p_program(x):
        return mt.allgather(mt.allreduce(x, op=mt.SUM))

    for np_ in (3, 2):
        want = j_analysis.check(j_program, jnp.arange(4.0), world_size=np_)
        got = analysis.check(p_program, torch.arange(4.0), world_size=np_)
        assert want.ok and got.ok, got.format_table()
        assert got.cache_key == want.cache_key


TAILS = {
    0: [b"tpucomm r0: self-heal: link to r1 recovered after 1 retry\n",
        b"ordinary line\n"],
    1: [b"tpucomm r1: self-heal: link to r2 DEAD after 3 retries\n",
        b"tpucomm_Send returned error code 1: r1: peer gone\n",
        b"\n"],
    2: [b"[elastic] slot 2: resuming from step 4 (generation 1)\n"],
    3: [],
}


def test_stderr_scans_equal_the_jax_launchers():
    assert p_launch._self_heal_outcomes(TAILS) == \
        j_launch._self_heal_outcomes(TAILS) == ({0: 1}, [(1, 2)])
    for tail in TAILS.values():
        assert p_launch._last_native_error(tail) == \
            j_launch._last_native_error(tail)


def test_policy_is_checked(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        p_launch.main(["-n", "2", "--elastic", "--elastic-policy", "grow",
                       "prog.py"])
    monkeypatch.setenv("MPI4JAX_TPU_ELASTIC_POLICY", "grow")
    with pytest.raises(SystemExit):
        p_launch.main(["-n", "2", "--elastic", "prog.py"])
    assert "shrink or respawn" in capsys.readouterr().err
