"""The PyTorch port's mesh ops' gradients held against ``jax.grad`` of the
JAX package's, on the CPU, and MAX/MIN refusing theirs as in the JAX
package (a part of ``tests/test_torch_mesh_ops.py``, which holds the
helpers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as m4j

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import _collectives as coll
from test_torch_mesh_ops import (LOCAL, NS, RTOL, _inputs, _port,  # noqa: F401
                                 _sum_tol)


# -- gradients ----------------------------------------------------------------

GRAD_N = 4


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of sum(w * op(x)) for each op, at GRAD_N ranks."""
    n = GRAD_N
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, n) + LOCAL).astype(np.float32)
    w = rng.standard_normal((5, n) + LOCAL).astype(np.float32)
    wg = rng.standard_normal((n, n) + LOCAL).astype(np.float32)
    mesh = m4j.make_mesh(n)

    def losses(x0, x1, x2a, x2b):
        def f(a, b, c, d, w0, w1, w2, w3, wg_):
            right = m4j.sendrecv(c, shift=1)
            left = m4j.sendrecv(d, shift=-1)
            return (jnp.sum(w0 * m4j.allreduce(a, op=m4j.SUM))
                    + jnp.sum(w1 * m4j.sendrecv(b, shift=1))
                    + jnp.sum(w2 * right) + jnp.sum(w3 * left)
                    + jnp.sum(wg_ * m4j.allgather(a)))[None]

        return jnp.sum(m4j.spmd(f, mesh=mesh)(
            x0, x1, x2a, x2b, w[0], w[1], w[2], w[3],
            wg.reshape(n * n, 1, *LOCAL)))

    grads = jax.jit(jax.grad(losses, argnums=(0, 1, 2, 3)))(*x)
    return x, w, wg, [np.asarray(g) for g in grads]


def test_gradients_match_jax(jax_grads):
    x, w, wg, ref = jax_grads
    n = GRAD_N
    comm = mt.make_mesh(n, device="cpu")
    xs = [torch.from_numpy(a).requires_grad_() for a in x]
    wt = [torch.from_numpy(a) for a in w]
    right, left = coll.ring_shift2(xs[2], xs[3], comm)
    gathered = coll.all_gather(xs[0], comm)
    summed = coll.allreduce_sum(xs[0], comm)
    shifted = coll.ring_shift(xs[1], comm, 1)
    for out in (right, left, gathered, summed, shifted):
        assert out.grad_fn is not None
    loss = ((wt[0] * summed).sum() + (wt[1] * shifted).sum()
            + (wt[2] * right).sum() + (wt[3] * left).sum()
            + (torch.from_numpy(wg) * gathered).sum())
    loss.backward()
    for i, (t, r) in enumerate(zip(xs, ref)):
        got = t.grad.numpy()
        tol = RTOL * (np.abs(w).sum() + np.abs(wg).sum())
        assert np.all(np.abs(got - r.reshape(got.shape)) <= tol), i


#: the six mesh gradients beyond allreduce SUM, sendrecv and allgather: per
#: case the op, the input's kind and the root
GRAD_OPS = ("bcast", "reduce_sum", "scan_sum", "gather", "scatter",
            "allreduce_prod")
GRAD_ROOT = 1
#: each gradient within this fraction of the case's largest gradient
#: magnitude of jax.grad's (the two sides associate sums differently)
GRAD_RTOL = 1e-6


def _grad_inputs(n):
    rng = np.random.default_rng(21)
    return {
        "bcast": rng.standard_normal((n,) + LOCAL),
        "reduce_sum": rng.standard_normal((n,) + LOCAL),
        "scan_sum": rng.standard_normal((n,) + LOCAL),
        "gather": rng.standard_normal((n,) + LOCAL),
        "scatter": rng.standard_normal((n, n) + LOCAL),
        "allreduce_prod": rng.uniform(0.5, 1.5, (n,) + LOCAL),
    }, {
        "bcast": rng.standard_normal((n,) + LOCAL),
        "reduce_sum": rng.standard_normal((n,) + LOCAL),
        "scan_sum": rng.standard_normal((n,) + LOCAL),
        "gather": rng.standard_normal((n, n) + LOCAL),
        "scatter": rng.standard_normal((n,) + LOCAL),
        "allreduce_prod": rng.standard_normal((n,) + LOCAL),
    }


def _jax_op(name, v):
    return {
        "bcast": lambda: m4j.bcast(v, root=GRAD_ROOT),
        "reduce_sum": lambda: m4j.reduce(v, op=m4j.SUM, root=GRAD_ROOT),
        "scan_sum": lambda: m4j.scan(v, op=m4j.SUM),
        "gather": lambda: m4j.gather(v, root=GRAD_ROOT),
        "scatter": lambda: m4j.scatter(v, root=GRAD_ROOT),
        "allreduce_prod": lambda: m4j.allreduce(v, op=m4j.PROD),
    }[name]()


def _port_op(name, v, comm):
    return {
        "bcast": lambda: mt.bcast(v, root=GRAD_ROOT, comm=comm),
        "reduce_sum": lambda: mt.reduce(v, op=mt.SUM, root=GRAD_ROOT,
                                        comm=comm),
        "scan_sum": lambda: mt.scan(v, op=mt.SUM, comm=comm),
        "gather": lambda: mt.gather(v, root=GRAD_ROOT, comm=comm),
        "scatter": lambda: mt.scatter(v, root=GRAD_ROOT, comm=comm),
        "allreduce_prod": lambda: mt.allreduce(v, op=mt.PROD, comm=comm),
    }[name]()


@pytest.fixture(scope="module")
def jax_op_grads():
    """jax.grad of sum(w * op(x)) for each of GRAD_OPS at GRAD_N ranks, in
    one compile: each op on its own input."""
    n = GRAD_N
    xs, ws = _grad_inputs(n)
    x32 = {k: v.astype(np.float32) for k, v in xs.items()}
    w32 = {k: v.astype(np.float32) for k, v in ws.items()}
    mesh = m4j.make_mesh(n)

    def losses(x):
        def f(*args):
            xv, wv = args[:len(GRAD_OPS)], args[len(GRAD_OPS):]
            total = 0.0
            for name, v, w in zip(GRAD_OPS, xv, wv):
                out = _jax_op(name, v)
                total = total + jnp.sum(w.reshape(out.shape) * out)
            return total[None]

        return jnp.sum(m4j.spmd(f, mesh=mesh)(
            *(x[k] for k in GRAD_OPS),
            *(w32[k].reshape((n, -1) + LOCAL) if k == "gather"
              else w32[k] for k in GRAD_OPS)))

    grads = jax.jit(jax.grad(losses))(
        {k: x32[k].reshape((n * n,) + LOCAL) if k == "scatter" else x32[k]
         for k in GRAD_OPS})
    return x32, w32, {k: np.asarray(g) for k, g in grads.items()}


@pytest.mark.parametrize("name", GRAD_OPS)
def test_op_gradients_match_jax(jax_op_grads, name):
    """The mesh gradients of bcast, reduce(SUM), scan(SUM), gather,
    scatter and allreduce(PROD) at n = 4 against jax.grad of the same JAX
    op on the same seeded inputs, within GRAD_RTOL of the case's largest
    gradient."""
    x, w, ref = jax_op_grads
    comm = mt.make_mesh(GRAD_N, device="cpu")
    leaf = torch.from_numpy(x[name]).requires_grad_()
    out = _port_op(name, leaf, comm)
    assert out.grad_fn is not None
    (torch.from_numpy(w[name]).reshape(out.shape) * out).sum().backward()
    got = leaf.grad.numpy()
    want = ref[name].reshape(got.shape)
    tol = GRAD_RTOL * float(np.abs(want).max())
    assert np.abs(want).max() > 0
    assert np.all(np.abs(got - want) <= tol), float(np.abs(got - want).max())


@pytest.mark.parametrize("front", ["allreduce", "reduce"])
@pytest.mark.parametrize("name", ["MAX", "MIN"])
def test_max_min_have_no_gradient_as_in_jax(front, name):
    """Only SUM is differentiable: ``jax.grad`` through ``lax.pmax`` and
    ``lax.pmin`` raises, and so does the port's backward.  Its forward
    values stay ``amax``/``amin`` over the ranks, bit for bit, with or
    without a gradient recorded."""
    n = GRAD_N
    x = np.random.default_rng(11).standard_normal((n, 4, 3)).astype(
        np.float32)
    jop, top = getattr(m4j, name), getattr(mt, name)

    def jfn(a):
        if front == "allreduce":
            return m4j.allreduce(a, op=jop)
        return m4j.reduce(a, op=jop, root=0)

    def tfn(a, comm):
        if front == "allreduce":
            return mt.allreduce(a, op=top, comm=comm)
        return mt.reduce(a, op=top, root=0, comm=comm)

    loss = lambda a: jnp.sum(m4j.spmd(jfn, mesh=m4j.make_mesh(n))(a))  # noqa: E731
    with pytest.raises(NotImplementedError, match=name.lower()):
        jax.grad(loss)(x)

    comm = mt.make_mesh(n, device="cpu")
    leaf = torch.from_numpy(x).requires_grad_()
    out = tfn(leaf, comm)
    with pytest.raises(NotImplementedError, match=f"op={name}.*only SUM"):
        out.sum().backward()
    fold = torch.amax if name == "MAX" else torch.amin
    want = fold(torch.from_numpy(x), dim=0, keepdim=True).expand(x.shape)
    if front == "reduce":
        want = torch.cat([want[:1], torch.from_numpy(x[1:])])
    with torch.no_grad():
        plain = tfn(torch.from_numpy(x), comm)
    for got in (out.detach(), plain):
        assert got.numpy().tobytes() == want.numpy().tobytes()
