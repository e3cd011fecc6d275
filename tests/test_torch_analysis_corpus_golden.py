"""The port's static verifier and schedule compiler on the golden
programs' torch twins, and the corpus's environment-driven verdicts.

- The six programs with a golden plan in
  ``tests/world_programs/golden_plans/``: the twin's report equals the JAX
  analyzer's (``tests/torch_analysis_twins.py``), and the port's compiled
  plan equals the golden file apart from ``"proof"``
  (``diff_plans(load_plan(golden), plan)`` is empty), ``cache_key``
  included.
- The virtual world loads no native library, opens no communicator and
  spawns no process.
"""

import os

import pytest

from torch_analysis_twins import (GOLDEN, GOLDEN_ENTRIES, analyze_jax,
                                  analyze_port, assert_twins, entry_id)


@pytest.mark.parametrize("entry", GOLDEN_ENTRIES, ids=entry_id)
def test_golden_plan_reproduced(entry, monkeypatch):
    from mpi4jax_tpu_torch import analysis

    # plans compiled with the knobs at their defaults, as the goldens were
    for knob in ("MPI4JAX_TPU_TUNE_MODEL", "MPI4JAX_TPU_PLAN_BUCKET_KB",
                 "MPI4JAX_TPU_COALESCE_BYTES", "MPI4JAX_TPU_PROGRESS_THREAD",
                 "MPI4JAX_TPU_ANALYZE_SYMBOLIC"):
        monkeypatch.delenv(knob, raising=False)
    name, np_ = entry["program"], entry["np"]
    port = analyze_port(name, np_)
    assert_twins(name, analyze_jax(name, np_), port)
    assert sorted(port.kinds()) == sorted(entry["kinds"])
    plan = analysis.plan_report(port)
    assert plan.rewritten == entry["rewritten"]
    golden = analysis.load_plan(os.path.join(GOLDEN, entry["golden"]))
    assert golden.cache_key == port.cache_key == plan.cache_key
    assert analysis.diff_plans(golden, plan) == ""


def test_no_native_library_socket_or_process(monkeypatch):
    """The virtual world never loads the transport, connects a comm or
    forks."""
    import subprocess

    from mpi4jax_tpu_torch.runtime import bridge

    def _boom(*a, **k):  # pragma: no cover - the assertion is the point
        raise AssertionError("analysis touched the native transport")

    monkeypatch.setattr(bridge, "get_lib", _boom)
    monkeypatch.setattr(bridge, "comm_init", _boom)
    monkeypatch.setattr(subprocess, "Popen", _boom)
    lib_before = bridge._lib
    for name, np_ in (("tag_mismatch.py", 2), ("moe_ops.py", 4),
                      ("subcomm_ops.py", 4)):
        report = analyze_port(name, np_)
        assert not any(f.kind == "rank_error" for f in report.findings), \
            report.format_table()
    assert "tag_mismatch" in analyze_port("tag_mismatch.py", 2).kinds()
    assert bridge._lib is lib_before
