"""The PyTorch port's mesh allreduce held against the JAX package's on
the CPU: its arms (butterfly, hop reduce-scatter/all-gather, fused ring),
the fused ring's plain version and gradient against
``topo.simulate_ring_sum`` bit for bit, the fronts' argument checks, and
the dtype and reduce-op tables (a part of
``tests/test_torch_mesh_ops.py``, which holds the helpers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as m4j
from mpi4jax_tpu.topo._simulate import simulate_ring_sum

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import _collectives as coll
from test_torch_mesh_ops import (LOCAL, NS, RTOL, _inputs, _port,  # noqa: F401
                                 _sum_tol)


# -- the arms of allreduce_sum ----------------------------------------------

ARMS = [
    (4, 5, "butterfly"),
    (8, 5, "butterfly"),
    (3, 5 * 1024, "hop_rs_ag"),
    (6, 5 * 1024, "hop_rs_ag"),
    (8, 5 * 1024, "hop_rs_ag"),
    (6, 1, "hop_rs_ag"),
    (4, 16 * 1024 + 37, "fused_ring"),
]


@pytest.fixture(scope="module")
def jax_arms():
    out = {}
    for n, count, _ in ARMS:
        x = np.random.default_rng(count + n).standard_normal(
            (n, count)).astype(np.float32)
        y = jax.jit(m4j.spmd(lambda v: m4j.allreduce(v, op=m4j.SUM),
                             mesh=m4j.make_mesh(n)))(x)
        out[(n, count)] = (x, np.asarray(y))
    return out


@pytest.mark.parametrize("n,count,arm", ARMS)
def test_allreduce_arms_match_jax(jax_arms, n, count, arm):
    assert coll.allreduce_arm(count, n) == arm
    x, ref = jax_arms[(n, count)]
    got = _port(n, lambda c, v: mt.allreduce(v, comm=c), x)
    assert np.all(np.abs(got - ref) <= _sum_tol(x))
    assert np.array_equal(got, np.broadcast_to(got[:1], got.shape))


@pytest.mark.parametrize("count", [1, 3, 513, 16 * 1024, 16 * 1024 + 37])
@pytest.mark.parametrize("n", [3, 4, 8])
def test_fused_ring_plain_is_simulate_ring_sum(n, count):
    rows = np.random.default_rng(count).standard_normal(
        (n, count)).astype(np.float32)
    got = coll.fused_ring_allreduce_plain(torch.from_numpy(rows)).numpy()
    want = simulate_ring_sum(list(rows))
    for r in range(n):
        assert got[r].tobytes() == want.tobytes()


def test_fused_ring_through_allreduce_is_simulate_ring_sum():
    n, count = 4, 16 * 1024 + 37
    rows = np.random.default_rng(1).standard_normal(
        (n, count)).astype(np.float32)
    got = _port(n, lambda c, v: mt.allreduce(v, comm=c), rows)
    assert got[0].tobytes() == simulate_ring_sum(list(rows)).tobytes()


def test_gradient_of_the_fused_ring_is_the_fused_ring():
    n, count = 4, 16 * 1024 + 37
    comm = mt.make_mesh(n, device="cpu")
    x = torch.zeros(n, count, requires_grad=True)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n, count)).astype(np.float32))
    coll.allreduce_sum(x, comm).backward(g)
    want = simulate_ring_sum(list(g.numpy()))
    assert x.grad[0].numpy().tobytes() == want.tobytes()


# -- arguments ----------------------------------------------------------------

def test_token_and_compression_raise():
    comm = mt.make_mesh(2, device="cpu")
    x = torch.ones(2, 3)
    with pytest.raises(TypeError, match="token"):
        mt.allreduce(x, comm=comm, token=object())
    with pytest.raises(ValueError, match="compression"):
        mt.allreduce(x, comm=comm, compression="fp8")
    with pytest.raises(NotImplementedError, match="compression"):
        mt.alltoall(torch.ones(2, 2, 3), comm=comm, compression="int8")
    for fn in (mt.allgather, mt.scan):
        with pytest.raises(TypeError, match="token"):
            fn(x, comm=comm, token=object())
    with pytest.raises(TypeError, match="token"):
        mt.sendrecv(x, shift=1, comm=comm, token=object())


def test_spmd_supplies_the_comm_and_checks_the_layout():
    comm = mt.make_mesh(3, device="cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2)

    @mt.spmd(comm=comm)
    def total(v):
        return mt.allreduce(v)

    np.testing.assert_array_equal(total(x).numpy(), [[6.0, 9.0]] * 3)
    with pytest.raises(ValueError, match="rank axes"):
        mt.allreduce(torch.ones(2, 2), comm=comm)
    with pytest.raises(RuntimeError, match="no communicator"):
        mt.allreduce(x)
    with pytest.raises(TypeError, match="not defined for boolean"):
        mt.allreduce(torch.ones(3, 2, dtype=torch.bool), comm=comm)


def test_several_devices_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.make_mesh(4, device=["cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mt.ProcessGrid((2, 2), device=["cuda:0", "cuda:1"])


def test_no_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the default device is the card")
    for make in (lambda: mt.make_mesh(2), lambda: mt.ProcessGrid((2, 2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# -- dtypes and reduce ops ----------------------------------------------------

def test_dtype_table_matches_jax():
    from mpi4jax_tpu.utils import dtypes as jax_dtypes

    from mpi4jax_tpu_torch.utils import dtypes

    names = {dtypes.dtype_name(d) for d in dtypes.SUPPORTED_DTYPES}
    assert names == {np.dtype(d).name for d in jax_dtypes.SUPPORTED_DTYPES}
    with pytest.raises(TypeError, match="does not support"):
        dtypes.check_supported(torch.float8_e4m3fn)


@pytest.mark.parametrize("name", [op.name for op in mt.ALL_OPS])
def test_reduce_ops_match_jax(name):
    jop = getattr(m4j, name)
    top = getattr(mt, name)
    rng = np.random.default_rng(5)
    if top.domain == "numeric":
        stack = rng.uniform(0.5, 1.5, (4, 6)).astype(np.float32)
    else:
        stack = rng.integers(0, 4, (4, 6)).astype(np.int32)
    t = torch.from_numpy(stack)
    np.testing.assert_allclose(top.reduce(t).numpy(),
                               np.asarray(jop.reduce(jnp.asarray(stack))),
                               rtol=RTOL)
    np.testing.assert_allclose(top.combine(t[0], t[1]).numpy(),
                               np.asarray(jop.combine(stack[0], stack[1])),
                               rtol=RTOL)
