"""The port's int8 mesh allreduce (``compression="int8"`` on a mesh comm)
held against a numpy oracle and the JAX package's, on the CPU.

The port's schedule (``ops/quantized.py:_quantized_schedule``) is bit for
bit ``quantized_allreduce_ref``, its numpy oracle in IEEE f32: scales
``absmax / 127``, codes ``rint(x / scale)``, the dequantized partials
added in rank order.  The JAX package's result on XLA:CPU is bit for bit
the same oracle under two rewrites of XLA's (``_xla_oracle`` below): the
scale ``absmax * fl(1/127)`` (the kernel-4 finding of ROADMAP.md §3) and
the dequantize-and-add fused into a multiply-add with one rounding.  So
the port and the JAX package agree exactly where those rewrites round as
IEEE does, and elsewhere within one quantization step: the ranks' chunk
scales plus the reduced chunk's scale.

Also as in the JAX package: the median error against the exact sum under
2e-2 and the largest under 0.2 of the largest sum
(``tests/collective_ops/test_quantized.py``), the bf16 dtype kept, a zero
gradient (``jax.grad`` through the schedule is zero: every value crosses
int8), non-SUM ops raising ``NotImplementedError`` and integer inputs
``TypeError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as m4j

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import quantized

N = 8
SHAPES = [(257,), (8, 33), (4, 4, 5), (4096,)]


def _fma_f32(a, b, c):
    """``fl(a * b + c)`` with one rounding (exact in f64 for these f32
    operands but for double rounding, which these inputs do not hit)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _xla_oracle(x):
    """The schedule under XLA:CPU's rewrites: the scale ``absmax *
    fl(1/127)`` and the partials' sum as fused multiply-adds in rank
    order."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    count = flat.shape[1]
    flat = np.concatenate([flat, np.zeros((n, (-count) % n), np.float32)], 1)

    def quant(v):
        amax = np.max(np.abs(v), -1)
        scale = np.where(amax > 0, amax * np.float32(1 / 127),
                         np.float32(1)).astype(np.float32)
        q = np.clip(np.rint(v / scale[..., None]), -127, 127)
        return q.astype(np.int8), scale

    q, s = quant(flat.reshape(n, n, -1))
    mine = q[0].astype(np.float32) * s[0][:, None]
    for r in range(1, n):
        mine = _fma_f32(q[r].astype(np.float32), s[r][:, None], mine)
    q2, s2 = quant(mine)
    full = (q2.astype(np.float32) * s2[:, None]).reshape(-1)[:count]
    return np.broadcast_to(full.reshape(x.shape[1:]), x.shape)


def _step(x):
    """Per element, one quantization step: the ranks' scales of its chunk
    plus the reduced chunk's scale (IEEE)."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    count = flat.shape[1]
    flat = np.concatenate([flat, np.zeros((n, (-count) % n), np.float32)], 1)
    chunks = flat.reshape(n, n, -1)
    s1 = np.abs(chunks).max(-1) / np.float32(127)  # [rank, chunk]
    red = quantized.quantized_allreduce_ref(x)[0].reshape(-1)
    red = np.concatenate([red, np.zeros((-count) % n, np.float32)])
    s2 = np.abs(red.reshape(n, -1)).max(-1) / np.float32(127)
    per_chunk = s1.sum(0) + s2
    k = chunks.shape[-1]
    return np.repeat(per_chunk, k)[:count].reshape(x.shape[1:])


@pytest.fixture(scope="module")
def mesh():
    return m4j.make_mesh(N)


def _jax_int8(mesh, x, op=None):
    kw = {} if op is None else {"op": op}
    return np.asarray(jax.jit(m4j.spmd(
        lambda v: m4j.allreduce(v, compression="int8", **kw),
        mesh=mesh))(x))


@pytest.mark.parametrize("n,shape", [(8, s) for s in SHAPES]
                         + [(3, (4, 4, 5)), (4, (1,)), (2, (70000,))])
def test_port_is_the_ieee_oracle_bit_for_bit(n, shape):
    x = np.random.RandomState(n).randn(n, *shape).astype(np.float32)
    got = mt.allreduce(torch.from_numpy(x), comm=mt.make_mesh(n, device="cpu"),
                       compression="int8")
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert got.numpy().tobytes() == quantized.quantized_allreduce_ref(
        x).tobytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_against_jax(mesh, shape):
    x = np.random.RandomState(0).randn(N, *shape).astype(np.float32)
    want = _jax_int8(mesh, x)
    # JAX's result is the oracle under XLA's two rewrites, bit for bit
    assert want.tobytes() == _xla_oracle(x).tobytes()
    got = mt.allreduce(torch.from_numpy(x), comm=mt.make_mesh(N, device="cpu"),
                       compression="int8").numpy()
    diff = np.abs(got - want)
    assert np.all(diff <= _step(x) * (1 + 1e-6))
    # and as accurate as the JAX package's own test asks
    exact = x.sum(0)
    for out in (got, want):
        err = np.abs(out - exact)
        assert np.median(err / np.maximum(np.abs(exact), 1e-3)) < 2e-2
        assert err.max() < 0.2 * np.abs(exact).max()


def test_bf16_is_kept(mesh):
    x = np.random.RandomState(1).randn(N, 64).astype(np.float32)
    want = jax.jit(m4j.spmd(lambda v: m4j.allreduce(v, compression="int8"),
                            mesh=mesh))(jnp.asarray(x).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = mt.allreduce(torch.from_numpy(x).to(torch.bfloat16),
                       comm=mt.make_mesh(N, device="cpu"), compression="int8")
    assert got.dtype == torch.bfloat16
    exact = x.sum(0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=0.05 * np.abs(exact).max())


def test_gradient_is_zero_as_jax(mesh):
    x = np.random.RandomState(2).randn(N, 33).astype(np.float32)
    g = jax.jit(jax.grad(lambda v: jnp.sum(m4j.spmd(
        lambda u: m4j.allreduce(u, compression="int8"), mesh=mesh)(v) ** 2)))(
        x)
    assert np.abs(np.asarray(g)).max() == 0.0
    comm = mt.make_mesh(N, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    (gt,) = torch.autograd.grad(
        (mt.allreduce(xt, comm=comm, compression="int8") ** 2).sum(), xt)
    assert gt.shape == xt.shape and not gt.any()
    # the exact allreduce's is not
    (ge,) = torch.autograd.grad((mt.allreduce(xt, comm=comm) ** 2).sum(), xt)
    assert ge.abs().max() > 0


def test_non_sum_and_non_float_raise_as_jax(mesh):
    comm = mt.make_mesh(N, device="cpu")
    x = np.ones((N, 3), np.float32)
    with pytest.raises(NotImplementedError):
        _jax_int8(mesh, x, op=m4j.MAX)
    with pytest.raises(NotImplementedError, match="op=SUM"):
        mt.allreduce(torch.from_numpy(x), op=mt.MAX, comm=comm,
                     compression="int8")
    xi = np.ones((N, 3), np.int32)
    with pytest.raises(TypeError):
        _jax_int8(mesh, xi)
    with pytest.raises(TypeError, match="real floating"):
        mt.allreduce(torch.from_numpy(xi), comm=comm, compression="int8")
    with pytest.raises(TypeError, match="real floating"):
        mt.allreduce(torch.ones(N, 3, dtype=torch.complex64), comm=comm,
                     compression="int8")
