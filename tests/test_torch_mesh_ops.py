"""The PyTorch port's mesh ops held against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX mesh ops
(on the 8-device CPU mesh of ``tests/conftest.py``, XLA collectives) and
through the port's ops on CPU tensors, where the collectives run their
plain versions (``hop_plain``, ``fused_ring_allreduce_plain``) in the
kernels' composition.  The JAX references are computed once per module,
one ``spmd`` call per ring size.

Tolerances: a SUM is held to ``rtol=1e-6`` of the sum of the magnitudes it
adds (the two sides associate differently: XLA's ``psum`` against the
port's butterfly, ring or fused ring); MAX, MIN, the logical ops,
all-gather and send/recv move or pick values and must agree exactly; PROD
and the custom op at ``rtol=1e-6``.  The fused ring's plain version is
held to the numpy oracle ``topo.simulate_ring_sum`` bit for bit.

Three files of at most 45 cases, each JAX compile with all its users: the
ops against the JAX mesh ops here; the allreduce's arms, the fused ring,
the arguments and the dtype and reduce-op tables in
``tests/test_torch_mesh_ops_ring.py``; the gradients in
``tests/test_torch_mesh_ops_grad.py``.  Both import the helpers from here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as m4j

import mpi4jax_tpu_torch as mt

NS = (2, 3, 4, 8)
LOCAL = (5,)
RTOL = 1e-6


def _inputs(n):
    rng = np.random.default_rng(n)
    return {
        "x": rng.standard_normal((n,) + LOCAL).astype(np.float32),
        "pos": rng.uniform(0.5, 1.5, (n,) + LOCAL).astype(np.float32),
        "bits": rng.integers(0, 2, (n,) + LOCAL).astype(np.int32),
    }


def _swap_perm(n):
    """A permutation that is no ring for n > 2: ranks 0 and n-1 swap, the
    others receive nothing."""
    return [(0, n - 1), (n - 1, 0)]


_JAX_ABSMAX = m4j.custom_op(
    "ABSMAX_TORCH_PARITY", lambda a, b: jnp.maximum(jnp.abs(a), jnp.abs(b)))
_TORCH_ABSMAX = mt.custom_op(
    "ABSMAX_TORCH_PARITY", lambda a, b: torch.maximum(a.abs(), b.abs()))


@pytest.fixture(scope="module")
def jax_ref():
    """Per n: the inputs and the JAX mesh ops' results, per rank."""
    out = {}
    for n in NS:
        inp = _inputs(n)
        mesh = m4j.make_mesh(n)

        def f(x, pos, bits, n=n):
            return {
                "SUM": m4j.allreduce(x, op=m4j.SUM),
                "MAX": m4j.allreduce(x, op=m4j.MAX),
                "MIN": m4j.allreduce(x, op=m4j.MIN),
                "PROD": m4j.allreduce(pos, op=m4j.PROD),
                "LAND": m4j.allreduce(bits, op=m4j.LAND),
                "ABSMAX": m4j.allreduce(x, op=_JAX_ABSMAX),
                "allgather": m4j.allgather(x),
                "shift+1": m4j.sendrecv(x, shift=1),
                "shift-1": m4j.sendrecv(x, shift=-1),
                "swap": m4j.sendrecv(x, perm=_swap_perm(n)),
                "scan": m4j.scan(x, op=m4j.SUM),
            }

        res = jax.jit(m4j.spmd(f, mesh=mesh))(
            inp["x"], inp["pos"], inp["bits"])
        out[n] = (inp, {k: np.asarray(v) for k, v in res.items()})
    return out


def _port(n, fn, *arrays):
    comm = mt.make_mesh(n, device="cpu")
    return fn(comm, *(torch.from_numpy(a) for a in arrays)).numpy()


def _sum_tol(x):
    """Per element, RTOL of the sum of the ranks' magnitudes."""
    return RTOL * np.abs(x).sum(axis=0, keepdims=True)


@pytest.mark.parametrize("n", NS)
def test_allreduce_sum_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.allreduce(x, op=mt.SUM, comm=c), inp["x"])
    assert np.all(np.abs(got - ref["SUM"].reshape(got.shape))
                  <= _sum_tol(inp["x"]))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", ["MAX", "MIN", "PROD", "LAND", "ABSMAX"])
def test_allreduce_ops_match_jax(jax_ref, n, name):
    inp, ref = jax_ref[n]
    op = {"MAX": mt.MAX, "MIN": mt.MIN, "PROD": mt.PROD, "LAND": mt.LAND,
          "ABSMAX": _TORCH_ABSMAX}[name]
    arg = {"PROD": "pos", "LAND": "bits"}.get(name, "x")
    got = _port(n, lambda c, x: mt.allreduce(x, op=op, comm=c), inp[arg])
    want = ref[name].reshape(got.shape)
    assert got.dtype == want.dtype
    if name in ("PROD", "ABSMAX"):
        np.testing.assert_allclose(got, want, rtol=RTOL)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", NS)
def test_allgather_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.allgather(x, comm=c), inp["x"])
    assert got.shape == (n, n) + LOCAL
    np.testing.assert_array_equal(got, ref["allgather"].reshape(got.shape))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("case", ["shift+1", "shift-1", "swap"])
def test_sendrecv_matches_jax(jax_ref, n, case):
    inp, ref = jax_ref[n]
    if case == "swap":
        fn = lambda c, x: mt.sendrecv(x, perm=_swap_perm(n), comm=c)  # noqa: E731
    else:
        shift = 1 if case == "shift+1" else -1
        fn = lambda c, x: mt.sendrecv(x, shift=shift, comm=c)  # noqa: E731
    got = _port(n, fn, inp["x"])
    np.testing.assert_array_equal(got, ref[case].reshape(got.shape))


@pytest.mark.parametrize("n", NS)
def test_scan_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.scan(x, op=mt.SUM, comm=c), inp["x"])
    assert np.all(np.abs(got - ref["scan"].reshape(got.shape))
                  <= _sum_tol(inp["x"]))
