"""The torch twins' sweep and their environment-driven verdicts, held to
the JAX analyzer on the originals (``tests/torch_analysis_twins.py``).

- ``full_ops.py``: every dtype, gradients, the batched forms, custom
  reduce ops and the int8 allreduce, 144 events a rank;
- ``ordering.py``'s verdict flips under ``MPI4JAX_TPU_PROGRESS_THREAD=0``
  (``order_critical_exchange``), in both packages;
- ``shm_schedule_mismatch.py`` gives its three kinds under
  ``MISMATCH_MODE``, in both packages.
"""

import pytest

from torch_analysis_twins import (FULL_OPS_ENTRIES, analyze_jax,
                                  analyze_port, assert_twins, check_entry,
                                  entry_id)


@pytest.mark.parametrize("entry", FULL_OPS_ENTRIES, ids=entry_id)
def test_full_ops_twin(entry):
    check_entry(entry)


def test_ordering_flips_without_progress_thread(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_PROGRESS_THREAD", raising=False)
    port = analyze_port("ordering.py", 2)
    assert port.ok, port.format_table()
    monkeypatch.setenv("MPI4JAX_TPU_PROGRESS_THREAD", "0")
    port = analyze_port("ordering.py", 2)
    assert_twins("ordering.py", analyze_jax("ordering.py", 2), port)
    f = next(f for f in port.findings
             if f.kind == "order_critical_exchange")
    assert set(f.ranks) == {0, 1}
    assert any("ordering.py:" in s for s in f.sites), f.sites
    assert not port.errors, port.format_table()


@pytest.mark.parametrize("mode,kind", [
    ("opcode", "collective_mismatch"),
    ("reduce_op", "reduce_op_mismatch"),
    ("dtype", "dtype_mismatch"),
])
def test_shm_schedule_mismatch_modes(mode, kind, monkeypatch):
    monkeypatch.setenv("MISMATCH_MODE", mode)
    port = analyze_port("shm_schedule_mismatch.py", 2)
    assert_twins("shm_schedule_mismatch.py",
                 analyze_jax("shm_schedule_mismatch.py", 2), port)
    assert kind in port.kinds(), port.format_table()
    f = next(f for f in port.findings if f.kind == kind)
    assert set(f.ranks) == {0, 1}
