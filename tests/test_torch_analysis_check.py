"""The port's ``analysis.check(fn)`` and ``plan_for``: counterparts of
``tests/test_analysis.py`` (its ``lax.cond`` and ``lax.while_loop`` cases
aside: torch has no staged control flow), held to the JAX analyzer.

``check`` runs the function once per rank in a virtual session; on the
same functions, written once in JAX and once in torch, the two packages'
schedules, ``cache_key``, true data dependence (``value_deps``) and plans
must be equal.  No native library is loaded and no process is spawned.
"""

import inspect
import json
import re
import sys
import warnings

import numpy as np
import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch import analysis

try:
    import jax
    import jax.numpy as jnp

    import mpi4jax_tpu as m4j
    from mpi4jax_tpu import analysis as jax_analysis
except Exception as err:  # pragma: no cover - old-jax containers
    pytest.skip(f"mpi4jax_tpu not importable here: {err}",
                allow_module_level=True)


def _strip(report):
    return {r: [s.split(" @ ", 1)[0] for s in v]
            for r, v in report.schedules.items()}


def _pair(jfn, tfn, shape=(4,), world_size=2):
    """Both packages' ``check`` on the same function, on ones of
    ``shape``."""
    jr = jax_analysis.check(jfn, jnp.ones(shape, jnp.float32),
                            world_size=world_size)
    tr = analysis.check(tfn, torch.ones(shape), world_size=world_size)
    return jr, tr


# ---- the JAX suite's cases --------------------------------------------------


def test_clean_spmd_with_loop_and_nested_call():
    def fn(x, comm):
        def inner(v):
            return mt.allreduce(v, op=mt.SUM, comm=comm)

        y = x
        for _ in range(3):
            y = inner(y)
        return mt.sendrecv(y, shift=1, comm=comm)

    report = analysis.check(fn, torch.ones(4), world_size=3)
    assert report.ok, report.format_table()
    # the loop unrolled by running it: 3 allreduces + 1 sendrecv per rank
    assert all(len(v) == 4 for v in report.schedules.values())


def test_rank_divergent_reduce_op_flagged():
    def fn(x):
        comm = mt.get_default_comm()
        op = mt.SUM if comm.rank() == 0 else mt.MAX
        return mt.allreduce(x, op=op, comm=comm)

    report = analysis.check(fn, torch.ones(2), world_size=2)
    assert "reduce_op_mismatch" in report.kinds()
    f = next(f for f in report.findings if f.kind == "reduce_op_mismatch")
    assert set(f.ranks) == {0, 1}
    assert any(".py:" in s for s in f.sites), f.sites


def test_unpaired_send_flagged():
    def fn(x, comm):
        if comm.rank() == 0:
            mt.send(x, dest=1, comm=comm)
        return x

    report = analysis.check(fn, torch.ones(2), world_size=2)
    assert "unmatched_send" in report.kinds()


def test_deadlock_by_recv_order():
    def fn(x, comm):
        peer = 1 - comm.rank()
        got = mt.recv(torch.zeros_like(x), source=peer, comm=comm)
        mt.send(got, dest=peer, comm=comm)
        return got

    report = analysis.check(fn, torch.ones(2), world_size=2)
    assert "deadlock" in report.kinds()


def test_forked_token_chain_flagged():
    def fn(x, comm):
        with mt.explicit_token_ordering():
            t1 = mt.create_token(x)
            rogue = mt.create_token()
            a, _ = mt.allreduce(x, op=mt.SUM, comm=comm, token=t1)
            b, _ = mt.allreduce(x, op=mt.SUM, comm=comm, token=rogue)
            return a + b

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report = analysis.check(fn, torch.ones(2), world_size=2)
    assert "token_violation" in report.kinds()
    # outside the verifier the guard tracks nothing: a run warns not
    assert mt.ops._world_impl._analysis_token_trace is None


def test_threaded_token_chain_clean():
    def fn(x, comm):
        with mt.explicit_token_ordering():
            t = mt.create_token(x)
            a, t = mt.allreduce(x, op=mt.SUM, comm=comm, token=t)
            b, t = mt.allreduce(a, op=mt.SUM, comm=comm, token=t)
            return b

    report = analysis.check(fn, torch.ones(2), world_size=2)
    assert report.ok, report.format_table()


def test_batched_and_grad_schedules_extracted():
    # the port's world ops have no vmap rule: the batched call is the op
    # on the stacked tensor, one message, as JAX's vmap sends
    def fn(x, comm):
        def ar(v):
            return mt.allreduce(v, op=mt.SUM, comm=comm)

        batched = ar(torch.stack([x, x]))
        v = x.clone().requires_grad_(True)
        ar(v).sum().backward()
        return batched.sum() + v.grad.sum()

    report = analysis.check(fn, torch.ones(3), world_size=2)
    assert report.ok, report.format_table()
    assert all(len(v) >= 1 for v in report.schedules.values())


def test_abstract_comm_never_touches_native():
    comm = analysis.AbstractComm(0, 4, device="cpu")
    with pytest.raises(analysis.AnalysisError):
        comm.handle
    assert comm.coll_algo("allreduce", 1024) == "analysis"


def test_schedule_signatures_cover_every_staged_op():
    """Every staged world op offers itself to the executor under a name
    with a schedule signature: a new op without one would be invisible to
    the verifier."""
    from mpi4jax_tpu_torch.ops import _world_impl as wi

    src = inspect.getsource(wi)
    offered = set(re.findall(r'ex\.run_op\("(\w+)"', src))
    assert len(offered) == 13
    assert offered == set(wi.SCHEDULE_SIGNATURES)
    for name in offered:
        assert wi.schedule_signature(name) is not None, name
    assert wi.schedule_signature("hop") is None


def test_split_inside_check_is_a_rank_error():
    def fn(x, comm):
        comm.split(color=0)
        return x

    report = analysis.check(fn, torch.ones(2), world_size=2)
    assert report.kinds() == {"rank_error"}, report.format_table()
    assert "analyze" in report.findings[0].message


# ---- the same functions in both packages ------------------------------------


def _jax_mixed(x, comm):
    a = m4j.allreduce(x, op=m4j.SUM, comm=comm)
    b = m4j.sendrecv(x * 2.0, shift=1, comm=comm)
    c = m4j.allreduce(a + b, op=m4j.MAX, comm=comm)
    d = m4j.allgather(x, comm=comm)
    return c.sum() + d.sum()


def _torch_mixed(x, comm):
    a = mt.allreduce(x, op=mt.SUM, comm=comm)
    b = mt.sendrecv(x * 2.0, shift=1, comm=comm)
    c = mt.allreduce(a + b, op=mt.MAX, comm=comm)
    d = mt.allgather(x, comm=comm)
    return c.sum() + d.sum()


def _jax_views(x, comm):
    y = m4j.allreduce(x, op=m4j.SUM, comm=comm)
    w = jnp.zeros((4,), jnp.float32).at[:2].set(y[:2])
    z = m4j.allreduce(w, op=m4j.SUM, comm=comm)
    return m4j.sendrecv(z + x, shift=1, comm=comm)


def _torch_views(x, comm):
    y = mt.allreduce(x, op=mt.SUM, comm=comm)
    w = torch.zeros((4,))
    w[:2] = y[:2]            # an in-place write of a view keeps the label
    z = mt.allreduce(w, op=mt.SUM, comm=comm)
    return mt.sendrecv(z + x, shift=1, comm=comm)


def _jax_chain(x, comm):
    rank = comm.rank()
    out = x
    for tag in range(3):
        if rank == 0:
            m4j.send(out, dest=1, tag=tag, comm=comm)
            out = m4j.recv(jnp.zeros_like(x), source=1, tag=tag, comm=comm)
        else:
            got = m4j.recv(jnp.zeros_like(x), source=0, tag=tag, comm=comm)
            m4j.send(got + 1.0, dest=0, tag=tag, comm=comm)
    fresh = m4j.allreduce(jnp.ones_like(x), op=m4j.SUM, comm=comm)
    return out + fresh


def _torch_chain(x, comm):
    rank = comm.rank()
    out = x
    for tag in range(3):
        if rank == 0:
            mt.send(out, dest=1, tag=tag, comm=comm)
            out = mt.recv(torch.zeros_like(x), source=1, tag=tag, comm=comm)
        else:
            got = mt.recv(torch.zeros_like(x), source=0, tag=tag, comm=comm)
            mt.send(got + 1.0, dest=0, tag=tag, comm=comm)
    fresh = mt.allreduce(torch.ones_like(x), op=mt.SUM, comm=comm)
    return out + fresh


def _jax_halo(x, comm):
    left = m4j.sendrecv(x[-1:], shift=1, comm=comm, sendtag=20)
    right = m4j.sendrecv(x[:1], shift=-1, comm=comm, sendtag=40)
    s = jnp.concatenate([left, x[1:-1], right])
    return m4j.allreduce(s, op=m4j.SUM, comm=comm)


def _torch_halo(x, comm):
    left = mt.sendrecv(x[-1:], shift=1, comm=comm, sendtag=20)
    right = mt.sendrecv(x[:1], shift=-1, comm=comm, sendtag=40)
    s = torch.cat([left, x[1:-1], right])
    return mt.allreduce(s, op=mt.SUM, comm=comm)


TWINS = {
    "mixed": (_jax_mixed, _torch_mixed, 2),
    "views": (_jax_views, _torch_views, 3),
    "chain": (_jax_chain, _torch_chain, 2),
    "halo": (_jax_halo, _torch_halo, 3),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_same_function_same_schedule_deps_and_plan(name, monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_TUNE_MODEL", raising=False)
    jfn, tfn, n = TWINS[name]
    jr, tr = _pair(jfn, tfn, world_size=n)
    assert jr.ok and tr.ok, (jr.format_table(), tr.format_table())
    assert _strip(tr) == _strip(jr)
    assert tr.cache_key == jr.cache_key
    assert tr.value_deps == jr.value_deps
    pj = jax_analysis.plan_report(jr)
    pt = analysis.plan_report(tr)
    assert json.dumps(pt.to_json(), sort_keys=True) == \
        json.dumps(pj.to_json(), sort_keys=True)


def test_plan_for_matches_jax(monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_TUNE_MODEL", raising=False)
    pj = jax_analysis.plan_for(_jax_chain, jnp.ones((4,), jnp.float32),
                               world_size=2)
    pt = analysis.plan_for(_torch_chain, torch.ones(4), world_size=2)
    assert pt.to_json() == pj.to_json()


def test_lost_provenance_depends_on_everything():
    """A payload that autograd made has no label: it takes every earlier
    event of its rank, so no plan may reorder it past them."""
    def fn(x, comm):
        a = mt.allreduce(x, op=mt.SUM, comm=comm)          # 0
        b = mt.allgather(x, comm=comm)                     # 1
        v = x.clone().requires_grad_(True)
        (mt.allreduce(v, op=mt.SUM, comm=comm) * 2).sum().backward()  # 2
        return mt.allreduce(v.grad, op=mt.SUM, comm=comm), a, b  # 3

    report = analysis.check(fn, torch.ones(3), world_size=2)
    assert report.ok, report.format_table()
    for deps in report.value_deps.values():
        assert {(0, 3), (1, 3), (2, 3)} <= deps


def test_no_native_library_or_process(monkeypatch):
    import subprocess

    from mpi4jax_tpu_torch.runtime import bridge

    def _boom(*a, **k):  # pragma: no cover - the assertion is the point
        raise AssertionError("analysis touched the native transport")

    monkeypatch.setattr(bridge, "get_lib", _boom)
    monkeypatch.setattr(bridge, "comm_init", _boom)
    monkeypatch.setattr(subprocess, "Popen", _boom)
    report = analysis.check(_torch_mixed, torch.ones(4), world_size=2)
    assert report.ok, report.format_table()
    x = np.ones(4, np.float32)
    assert analysis.check(_torch_chain, torch.from_numpy(x),
                          world_size=2).ok


def test_virtual_world_under_contention():
    """Sixteen rank threads (more than this host's cores) with the
    interpreter switching threads every microsecond: every value the
    shared matcher hands out must still be right (a lost update would
    give a wrong sum or a stall)."""
    def fn(x, comm):
        rank, n = comm.rank(), comm.size()
        for step in range(20):
            total = mt.allreduce(x * (rank + step), op=mt.SUM, comm=comm)
            assert torch.equal(total, x * (n * (n - 1) // 2 + n * step))
            got = mt.sendrecv(x * rank, shift=1, comm=comm, sendtag=step)
            assert torch.equal(got, x * ((rank - 1) % n))
            rows = mt.alltoall(torch.stack([x * (100 * rank + d)
                                            for d in range(n)]), comm=comm)
            assert torch.equal(rows, torch.stack(
                [x * (100 * s + rank) for s in range(n)]))
        return total

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        report = analysis.check(fn, torch.ones(3), world_size=16)
    finally:
        sys.setswitchinterval(old)
    assert report.ok, report.format_table()
    assert all(len(v) == 60 for v in report.schedules.values())
    assert len(report.results) == 16


def test_event_rank_comes_from_the_comm():
    """A world op issued from a thread of the program's own (not the rank
    thread) is the rank's event: its rank is read off its comm.  The
    backward of a rank thread runs on that thread, autograd's
    multithreaded backward being off there."""
    import threading

    def fn(x, comm):
        assert not torch.autograd.is_multithreading_enabled()
        out = {}
        helper = threading.Thread(target=lambda: out.update(
            y=mt.allreduce(x * (comm.rank() + 1), op=mt.SUM, comm=comm)))
        helper.start()
        helper.join(60)
        return out["y"]

    report = analysis.check(fn, torch.ones(2), world_size=3)
    assert report.ok, report.format_table()
    assert all(len(v) == 1 for v in report.schedules.values())
    for r in range(3):
        assert report.events[r][0].rank == r
        assert torch.equal(report.results[r], torch.full((2,), 6.0))


@pytest.mark.parametrize("raw", [None, "", "auto", "off", " off ", "on",
                                 "OFF"])
def test_symbolic_knob_parses_as_jax(raw, monkeypatch):
    """``MPI4JAX_TPU_ANALYZE_SYMBOLIC``: the port's config and
    ``_symbolic`` parse it as the JAX package's config does, a bad value
    raising in all three."""
    from mpi4jax_tpu.utils import config as jconfig

    from mpi4jax_tpu_torch.analysis import _symbolic
    from mpi4jax_tpu_torch.utils import config

    if raw is None:
        monkeypatch.delenv("MPI4JAX_TPU_ANALYZE_SYMBOLIC", raising=False)
    else:
        monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_SYMBOLIC", raw)
    got = []
    for parse in (jconfig.analyze_symbolic_mode, config.analyze_symbolic_mode,
                  _symbolic.symbolic_mode):
        try:
            got.append(parse())
        except ValueError:
            got.append(ValueError)
    assert got[0] == got[1] == got[2], got


@pytest.mark.parametrize("raw", [None, "", "30", "0.5", "0", "-3", "soon"])
def test_timeout_knob_parses_as_jax(raw, monkeypatch):
    from mpi4jax_tpu.utils import config as jconfig

    from mpi4jax_tpu_torch.utils import config

    if raw is None:
        monkeypatch.delenv("MPI4JAX_TPU_ANALYZE_TIMEOUT_S", raising=False)
    else:
        monkeypatch.setenv("MPI4JAX_TPU_ANALYZE_TIMEOUT_S", raw)
    got = []
    for parse in (jconfig.analyze_timeout_s, config.analyze_timeout_s):
        try:
            got.append(parse())
        except ValueError:
            got.append(ValueError)
    assert got[0] == got[1], got
