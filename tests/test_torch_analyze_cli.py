"""``python -m mpi4jax_tpu_torch.analyze`` and ``launch --verify``.

The CLI's exit codes are the JAX package's (0 clean, 3 findings or plan
drift, 2 usage or analyzer error); ``--emit-plan`` writes the golden plan
of ``tests/world_programs/golden_plans/`` apart from ``"proof"``;
``--diff-plan`` reports drift; ``-m`` analyzes a module.  The launcher's
pre-flight lets a clean program run (``basic_ops``, launched for real at
np 2 on the CPU, beside a plain launch of ``independent_pair``) and stops
a broken one with exit 3 before any rank is spawned (``tag_mismatch``).
"""

import json
import os
import shutil
import subprocess
import sys
import threading

import pytest

from mpi4jax_tpu_torch.analysis import _cli
from mpi4jax_tpu_torch.runtime import bridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGS = os.path.join(REPO, "tests", "torch_world_programs")
GOLDEN = os.path.join(REPO, "tests", "world_programs", "golden_plans")
CPU = ["--", "--device", "cpu"]


def _prog(name):
    return os.path.join(PROGS, name)


def _cli_run(args, capsys):
    rc = _cli.main(args)
    return rc, capsys.readouterr()


@pytest.mark.parametrize("name,np_,rc", [
    ("basic_ops.py", 2, 0),
    ("tag_mismatch.py", 2, 3),
    ("epoch_rendezvous_divergent.py", 2, 3),
])
def test_exit_codes(name, np_, rc, capsys):
    got, out = _cli_run([_prog(name), "--np", str(np_)] + CPU, capsys)
    assert got == rc, out.out
    if rc:
        assert "ERROR" in out.out


def test_usage_and_analyzer_errors_exit_2(tmp_path, capsys):
    assert _cli_run([str(tmp_path / "missing.py"), "--np", "2"],
                    capsys)[0] == 2
    assert _cli_run([_prog("basic_ops.py"), "--np", "0"], capsys)[0] == 2
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    assert _cli_run([str(bad), "--np", "2"], capsys)[0] == 2
    assert _cli_run(["-m", "no_such_module_here", "--np", "2"],
                    capsys)[0] == 2


def test_errors_only_lets_warnings_pass(monkeypatch, capsys):
    # with the progress engine off the exchange is order-critical: a
    # warning, which fails the plain run and passes --errors-only
    monkeypatch.setenv("MPI4JAX_TPU_PROGRESS_THREAD", "0")
    rc, out = _cli_run([_prog("ordering.py"), "--np", "2"] + CPU, capsys)
    assert rc == 3 and "order_critical_exchange" in out.out
    rc, out = _cli_run([_prog("ordering.py"), "--np", "2",
                        "--errors-only"] + CPU, capsys)
    assert rc == 0 and "WARNING" in out.out


def test_json_schedules_and_module(capsys):
    rc, out = _cli_run(["-m", "mpi4jax_tpu_torch.examples.world_hello",
                        "--np", "4", "--json"] + CPU, capsys)
    assert rc == 0
    blob = json.loads(out.out)
    assert blob["ok"] and blob["world_size"] == 4
    assert blob["analyzer_version"] == "7.0"
    assert all(len(v) > 0 for v in blob["schedules"].values())
    assert blob["target"].endswith("world_hello.py")
    rc, out = _cli_run([_prog("basic_ops.py"), "--np", "2", "--schedules",
                        "--show-output"] + CPU, capsys)
    assert rc == 0
    assert "-- rank 1 schedule --" in out.out
    assert "basic_ops OK" in out.out  # the program's captured output


@pytest.mark.parametrize("name,np_,golden", [
    ("independent_pair.py", 2, "independent_pair.np2.plan.json"),
    ("halo_exchange.py", 3, "halo_exchange.np3.plan.json"),
])
def test_emit_plan_writes_the_golden_file(name, np_, golden, tmp_path,
                                          monkeypatch, capsys):
    for knob in ("MPI4JAX_TPU_TUNE_MODEL", "MPI4JAX_TPU_PLAN_BUCKET_KB",
                 "MPI4JAX_TPU_COALESCE_BYTES",
                 "MPI4JAX_TPU_PROGRESS_THREAD"):
        monkeypatch.delenv(knob, raising=False)
    out = tmp_path / "plan.json"
    rc, _ = _cli_run([_prog(name), "--np", str(np_), "--emit-plan",
                      str(out)] + CPU, capsys)
    assert rc == 0
    with open(out) as f:
        mine = json.load(f)
    with open(os.path.join(GOLDEN, golden)) as f:
        want = json.load(f)
    mine.pop("proof")
    want.pop("proof")
    assert mine == want


def test_diff_plan(monkeypatch, capsys):
    for knob in ("MPI4JAX_TPU_TUNE_MODEL", "MPI4JAX_TPU_PLAN_BUCKET_KB",
                 "MPI4JAX_TPU_COALESCE_BYTES",
                 "MPI4JAX_TPU_PROGRESS_THREAD"):
        monkeypatch.delenv(knob, raising=False)
    own = os.path.join(GOLDEN, "independent_pair.np2.plan.json")
    other = os.path.join(GOLDEN, "quant_ops.np2.plan.json")
    prog = _prog("independent_pair.py")
    rc, out = _cli_run([prog, "--np", "2", "--diff-plan", own] + CPU, capsys)
    assert rc == 0, out.err
    rc, out = _cli_run([prog, "--np", "2", "--diff-plan", other, "--json"]
                       + CPU, capsys)
    assert rc == 3
    assert json.loads(out.out)["plan_drift"]
    rc, out = _cli_run([prog, "--np", "2", "--diff-plan",
                        os.path.join(GOLDEN, "missing.json")] + CPU, capsys)
    assert rc == 2


def test_verify_then_run_and_a_plain_launch(tmp_path):
    """Three launches side by side on the CPU: ``basic_ops`` verified
    clean and then run for real at np 2, ``independent_pair`` launched for
    real (the twins are sound programs, not just analyzable ones), and
    ``tag_mismatch`` stopped by the pre-flight with exit 3 before any rank
    starts (its ranks would print)."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("g++ is not on PATH: the native transport cannot be "
                    "built here")
    # the transport's build in the background: the pre-flights and the
    # ranks' imports run meanwhile, then the ranks wait on its lock
    build = threading.Thread(target=bridge.build, daemon=True)
    build.start()
    env = dict(os.environ, PYTHONPATH=REPO)
    launcher = [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch",
                "-n", "2", "--timeout", "120"]
    cmds = {
        "basic_ops": launcher + ["--verify", _prog("basic_ops.py"),
                                 "--device", "cpu"],
        "independent_pair": launcher + [_prog("independent_pair.py"),
                                        "--device", "cpu"],
        "tag_mismatch": launcher + ["--verify", _prog("tag_mismatch.py"),
                                    "--device", "cpu"],
    }
    res = {}

    def job(name):
        res[name] = subprocess.run(cmds[name], capture_output=True,
                                   text=True, env=env, cwd=str(tmp_path),
                                   timeout=180)

    threads = [threading.Thread(target=job, args=(n,)) for n in cmds]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    build.join()
    b, p, t = (res["basic_ops"], res["independent_pair"],
               res["tag_mismatch"])
    assert b.returncode == 0, b.stderr[-2000:]
    assert "clean at np=2" in b.stderr
    assert b.stdout.count("basic_ops OK") == 2
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.count("independent_pair OK") == 2
    assert t.returncode == 3, t.stderr[-2000:]
    assert "no rank was spawned" in t.stderr
    assert "tag_mismatch" in t.stderr
    assert "UNREACHABLE" not in t.stdout + t.stderr
