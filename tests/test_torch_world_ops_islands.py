"""The port's world tier held to the JAX package: the 4-rank job on
``--fake-hosts 'r0,r1|r2,r3'`` (a multi-island world, so ``algo=None``
resolves against the hierarchical default table), and the world ops'
gradient refusals shown without a transport.

The cases of ``tests/test_torch_world_ops.py`` (which holds the 3-rank
job's, the job's launch and the JAX references) at n = 4: each wrapper
runs that file's test on this file's job.
"""

import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.benchmarks import world_ops as wo
from mpi4jax_tpu_torch.ops import _world_impl
import test_torch_world_ops as base
from test_torch_world_ops import local_world  # noqa: F401

NS = (4,)


@pytest.fixture(scope="module")
def world():
    """The 4-rank job and its JAX references."""
    yield from base.launch_world(NS)


@pytest.mark.parametrize("n", NS)
def test_every_rank_held_every_oracle(world, n):
    base.test_every_rank_held_every_oracle(world, n)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dt", wo.DTYPES)
def test_reductions_match_jax(world, n, dt):
    base.test_reductions_match_jax(world, n, dt)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dt", wo.OTHER_DTYPES)
def test_other_wire_dtypes_reduce(world, n, dt):
    base.test_other_wire_dtypes_reduce(world, n, dt)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dt", wo.DTYPES)
def test_data_movement_matches_jax(world, n, dt):
    base.test_data_movement_matches_jax(world, n, dt)


@pytest.mark.parametrize("n", NS)
def test_custom_op_matches_jax(world, n):
    base.test_custom_op_matches_jax(world, n)


@pytest.mark.parametrize("n", NS)
def test_f32_schedules_match_the_jax_simulators(world, n, monkeypatch):
    base.test_f32_schedules_match_the_jax_simulators(world, n, monkeypatch)


@pytest.mark.parametrize("n", NS)
def test_int8_matches_the_jax_simulators(world, n, monkeypatch):
    base.test_int8_matches_the_jax_simulators(world, n, monkeypatch)


@pytest.mark.parametrize("n", NS)
def test_gradients_follow_the_jax_rules(world, n):
    base.test_gradients_follow_the_jax_rules(world, n)


@pytest.mark.parametrize("n", NS)
def test_neighbor_exchange_walls_and_self_wrap(world, n):
    base.test_neighbor_exchange_walls_and_self_wrap(world, n)


@pytest.mark.parametrize("call", [
    lambda x, c: mt.allreduce(x, op=mt.MAX, comm=c),
    lambda x, c: mt.allreduce(x, op=mt.PROD, comm=c),
    lambda x, c: mt.allgather(x, comm=c),
    lambda x, c: mt.bcast(x, 1, comm=c),
    lambda x, c: mt.gather(x, 0, comm=c),
    lambda x, c: mt.reduce(x, op=mt.SUM, root=0, comm=c),
    lambda x, c: mt.scan(x, comm=c),
    lambda x, c: mt.scatter(x.expand(4, 4), 0, comm=c),
    lambda x, c: mt.alltoall(x.expand(4, 4), comm=c),
    lambda x, c: mt.neighbor_exchange(x, x * 2, lo=1, hi=3, comm=c)[0],
], ids=["MAX", "PROD", "allgather", "bcast", "gather", "reduce", "scan",
        "scatter", "alltoall", "neighbor_exchange"])
def test_other_world_ops_have_no_gradient(local_world, call):
    """Their backward raises, as ``jax.grad`` does for want of a rule; the
    forward stays connected to the graph (nothing is detached)."""
    x = torch.arange(4, dtype=torch.float32).requires_grad_()
    y = call(x, local_world)
    assert y.requires_grad
    with pytest.raises(NotImplementedError, match="no gradient"):
        y.sum().backward()


def test_sendrecv_gradient_swaps_the_edge_and_tags(local_world,
                                                   monkeypatch):
    """The transpose of ``:1576-1595`` there: source and dest swapped, the
    tags too, and a wildcard receive tag keeps the own send tag."""
    calls = []

    def record(x, source, dest, sendtag, recvtag, status, comm):
        calls.append((source, dest, sendtag, recvtag))
        return x.detach().clone()

    monkeypatch.setattr(_world_impl, "_sendrecv", record)
    x = torch.ones(3, requires_grad=True)
    mt.sendrecv(x, source=1, dest=2, sendtag=5, recvtag=6,
                comm=local_world).sum().backward()
    mt.sendrecv(x, source=1, dest=2, sendtag=5, recvtag=mt.ANY_TAG,
                status=mt.Status(), comm=local_world).sum().backward()
    assert calls == [(1, 2, 5, 6), (2, 1, 6, 5),
                     (1, 2, 5, mt.ANY_TAG), (2, 1, 5, mt.ANY_TAG)]
    assert torch.equal(x.grad, torch.full((3,), 2.0))
