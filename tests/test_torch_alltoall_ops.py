"""The PyTorch port's alltoall and the fronts built on it, held against the
JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX mesh ops
(on the 8-device CPU mesh of ``tests/conftest.py``) and through the port's
ops on CPU tensors, where the alltoall runs its plain version
(``alltoall_plain``, an index copy).  The identities replayed are those of
``tests/collective_ops/test_collectives.py`` (alltoall, bcast, reduce,
scatter, gather, barrier, send/recv); the plain alltoall is also held
against the JAX package's direct alltoall kernel (``pallas_collectives.
alltoall``, in interpret mode as its own tests run it on the CPU) and
``lax.all_to_all``, on a ``(4,)`` mesh and on both axes of a ``(2, 4)``
mesh, in f32 and complex64, and its gradient against ``jax.grad``.

Tolerances: everything that moves or picks values (alltoall, scatter,
gather, bcast, MAX, the gradient) must agree exactly; a SUM is held to
``rtol=1e-6`` of the sum of the magnitudes it adds, as in
``test_torch_mesh_ops.py`` (XLA's ``psum`` and the port's butterfly or ring
associate differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

import mpi4jax_tpu as m4j
from mpi4jax_tpu.ops import pallas_collectives as pc

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.parallel.mesh import MeshComm
from mpi4jax_tpu_torch.utils.validation import ValidationError

NS = (3, 8)
RTOL = 1e-6
BCAST_ROOTS = [(8, 0), (8, 3), (8, 7), (3, 1)]
REDUCE_ROOTS = [(8, 0), (8, 5), (3, 2)]
SCATTER_ROOTS = [(8, 0), (8, 4), (3, 2)]


def _inputs(n):
    rng = np.random.default_rng(40 + n)
    return {
        "a2a": rng.standard_normal((n * n, 3)).astype(np.float32),
        "x": rng.standard_normal((n, 2)).astype(np.float32),
        "bits": rng.integers(0, 2, (n, 1)).astype(bool),
        "buf": rng.standard_normal((n * n, 2)).astype(np.float32),
        "buf3": rng.standard_normal((n * n, 3)).astype(np.float32),
        "scalar": rng.standard_normal((n,)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def jax_ref():
    """Per n: the inputs and the JAX mesh fronts' results, global (the
    ranks' outputs concatenated along the first axis)."""
    out = {}
    for n in NS:
        inp = _inputs(n)
        bcast_roots = [r for m, r in BCAST_ROOTS if m == n]
        reduce_roots = [r for m, r in REDUCE_ROOTS if m == n]
        scatter_roots = [r for m, r in SCATTER_ROOTS if m == n]

        def f(a2a, x, bits, buf, buf3, scalar, n=n):
            res = {"alltoall": m4j.alltoall(a2a), "bcast_bool":
                   m4j.bcast(bits, 1), "max": m4j.reduce(x, m4j.MAX, 2 % n),
                   "gather": m4j.gather(scalar, 0),
                   "roundtrip": m4j.gather(m4j.scatter(buf3, 0), 0)}
            for r in bcast_roots:
                res[f"bcast{r}"] = m4j.bcast(x, r)
            for r in reduce_roots:
                res[f"reduce{r}"] = m4j.reduce(x, m4j.SUM, r)
            for r in scatter_roots:
                res[f"scatter{r}"] = m4j.scatter(buf, r)
            m4j.barrier()
            res["after_barrier"] = scalar
            return res

        res = jax.jit(m4j.spmd(f, mesh=m4j.make_mesh(n)))(
            inp["a2a"], inp["x"], inp["bits"], inp["buf"], inp["buf3"],
            inp["scalar"])
        out[n] = (inp, {k: np.asarray(v) for k, v in res.items()})
    return out


def _port(n, fn, a):
    """``fn(comm, x)`` on the port, ``a`` global as the JAX side takes it:
    rank r's block is ``a``'s r-th slice along the first axis."""
    comm = mt.make_mesh(n, device="cpu")
    x = torch.from_numpy(a).reshape(n, a.shape[0] // n, *a.shape[1:])
    return fn(comm, x).numpy()


def _sum_tol(x, n):
    """Per element, RTOL of the sum of the ranks' magnitudes."""
    return RTOL * np.abs(x.reshape(n, -1)).sum(axis=0)


@pytest.mark.parametrize("n", NS)
def test_alltoall_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.alltoall(x, comm=c), inp["a2a"])
    np.testing.assert_array_equal(got.reshape(ref["alltoall"].shape),
                                  ref["alltoall"])
    # rank r's row j is rank j's row r
    src = inp["a2a"].reshape(n, n, 3)
    np.testing.assert_array_equal(got, src.transpose(1, 0, 2))


def test_alltoall_bad_leading_axis():
    comm = mt.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="leading axis"):
        mt.alltoall(torch.ones(4, 3, 2), comm=comm)
    with pytest.raises(ValueError, match="leading axis"):
        mt.alltoall(torch.ones(4), comm=comm)


@pytest.mark.parametrize("n,root", BCAST_ROOTS)
def test_bcast_matches_jax(jax_ref, n, root):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.bcast(x, root, comm=c), inp["x"])
    want = ref[f"bcast{root}"]
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(
        got.reshape(n, 2), np.broadcast_to(inp["x"][root], (n, 2)))


@pytest.mark.parametrize("n", NS)
def test_bcast_bool_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.bcast(x, 1, comm=c), inp["bits"])
    assert got.dtype == np.bool_ == ref["bcast_bool"].dtype
    np.testing.assert_array_equal(got.reshape(n, 1), ref["bcast_bool"])
    np.testing.assert_array_equal(got.reshape(n, 1),
                                  np.broadcast_to(inp["bits"][1], (n, 1)))


@pytest.mark.parametrize("n,root", REDUCE_ROOTS)
def test_reduce_matches_jax(jax_ref, n, root):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.reduce(x, mt.SUM, root, comm=c),
                inp["x"]).reshape(n, 2)
    want = ref[f"reduce{root}"]
    assert np.all(np.abs(got[root] - want[root]) <= _sum_tol(inp["x"], n))
    others = [r for r in range(n) if r != root]
    # non-root ranks keep their input (the reference contract)
    np.testing.assert_array_equal(got[others], want[others])
    np.testing.assert_array_equal(got[others], inp["x"][others])


@pytest.mark.parametrize("n", NS)
def test_reduce_max_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    root = 2 % n
    got = _port(n, lambda c, x: mt.reduce(x, mt.MAX, root, comm=c),
                inp["x"]).reshape(n, 2)
    np.testing.assert_array_equal(got, ref["max"])
    np.testing.assert_array_equal(got[root], inp["x"].max(axis=0))


@pytest.mark.parametrize("n,root", SCATTER_ROOTS)
def test_scatter_matches_jax(jax_ref, n, root):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.scatter(x, root, comm=c), inp["buf"])
    want = ref[f"scatter{root}"]
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    # rank j receives row j of the root's buffer
    np.testing.assert_array_equal(got, inp["buf"].reshape(n, n, 2)[root])


@pytest.mark.parametrize("n", NS)
def test_scatter_gather_roundtrip_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.gather(mt.scatter(x, 0, comm=c), 0,
                                          comm=c), inp["buf3"])
    np.testing.assert_array_equal(got.reshape(ref["roundtrip"].shape),
                                  ref["roundtrip"])
    root_buf = inp["buf3"].reshape(n, n, 3)[0]
    for r in range(n):
        np.testing.assert_array_equal(got[r], root_buf)


@pytest.mark.parametrize("n", NS)
def test_gather_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    got = _port(n, lambda c, x: mt.gather(x, 0, comm=c), inp["scalar"])
    assert got.shape == (n, n, 1)
    np.testing.assert_array_equal(got.reshape(ref["gather"].shape),
                                  ref["gather"])


@pytest.mark.parametrize("n", NS)
def test_barrier_matches_jax(jax_ref, n):
    inp, ref = jax_ref[n]
    comm = mt.make_mesh(n, device="cpu")
    assert mt.barrier(comm=comm) is None
    with comm:
        assert mt.barrier() is None
    np.testing.assert_array_equal(ref["after_barrier"], inp["scalar"])


def test_send_recv_raise_on_the_mesh():
    comm = mt.make_mesh(8, device="cpu")
    x = torch.ones(8)
    with pytest.raises(NotImplementedError, match="SPMD"):
        mt.send(x, 0, comm=comm)
    with pytest.raises(NotImplementedError, match="SPMD"):
        mt.recv(x, 0, comm=comm)
    with pytest.raises(NotImplementedError, match="world-tier"):
        mt.neighbor_exchange(x, x, lo=None, hi=None, comm=comm)


def test_front_arguments():
    comm = mt.make_mesh(4, device="cpu")
    x = torch.ones(4, 4)
    # token= returns (result, token), the result the tokenless call's; a
    # token that is no tensor raises TypeError, as in the JAX package
    t = mt.create_token(x)
    for fn in (mt.alltoall, mt.bcast, mt.reduce, mt.gather, mt.scatter):
        got, tok = fn(x, comm=comm, token=t)
        assert got.numpy().tobytes() == fn(x, comm=comm).numpy().tobytes()
        assert tok.dtype == torch.uint32 and tok.dim() == 0
        with pytest.raises(TypeError, match="token"):
            fn(x, comm=comm, token=object())
    assert mt.barrier(comm=comm, token=t) is t
    assert mt.barrier(comm=comm) is None
    with pytest.raises(NotImplementedError, match="compression"):
        mt.alltoall(x, comm=comm, compression="int8")
    with pytest.raises(NotImplementedError, match="algo"):
        mt.alltoall(x, comm=comm, algo="ring")
    for fn in (mt.bcast, mt.reduce, mt.gather, mt.scatter):
        with pytest.raises(ValidationError, match="out of range"):
            fn(x, root=4, comm=comm)
        with pytest.raises(ValidationError, match="integer"):
            fn(x, root=1.0, comm=comm)
    with pytest.raises(ValueError, match=r"scatter requires input shape"):
        mt.scatter(torch.ones(4, 3), 0, comm=comm)


def test_alltoall_of_one_rank_is_the_input():
    comm = mt.make_mesh(1, device="cpu")
    x = torch.arange(6.0).reshape(1, 1, 6)
    assert mt.alltoall(x, comm=comm) is x
    np.testing.assert_array_equal(mt.scatter(x, 0, comm=comm).numpy(),
                                  x[:, 0].numpy())


@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.bfloat16,
                                   torch.float64, torch.complex64])
def test_plain_alltoall_moves_every_dtype(dtype):
    """Grid sub-comms, any dtype: out[f, j] = x[peer(f, j), c_f]."""
    grid = mt.ProcessGrid((2, 4), device="cpu")
    rng = np.random.default_rng(3)
    for d in (0, 1):
        comm = grid.axis_comm(d)
        n = comm.size()
        raw = rng.integers(-100, 100, (2, 4, n, 3, 5))
        x = torch.from_numpy(raw).to(dtype)
        got = mt.alltoall(x, comm=comm)
        flat = x.reshape(8, n, 15)
        for f, c in enumerate(comm.ranks()):
            for j in range(n):
                want = flat[comm.peer(f, j), c]
                assert torch.equal(got.reshape(8, n, 15)[f, j], want)


# -- against the JAX package's direct alltoall kernel and lax.all_to_all -----


def _pc_and_lax(v, axis, n, width):
    r = v.reshape(n, -1, width)
    return (pc.alltoall(r, axis).reshape(v.shape),
            lax.all_to_all(r, axis, split_axis=0, concat_axis=0)
            .reshape(v.shape))


@pytest.fixture(scope="module")
def jax_direct():
    """The direct alltoall kernel (interpret mode) and lax.all_to_all on a
    (4,) mesh (f32, complex64 and jax.grad) and on both axes of a (2, 4)
    mesh, two jitted calls in all."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((4 * 4 * 3, 8)).astype(np.float32)
    xc = (rng.standard_normal((4 * 4, 8))
          + 1j * rng.standard_normal((4 * 4, 8))).astype(np.complex64)
    xg = rng.standard_normal((4 * 4, 6)).astype(np.float32)
    w = rng.standard_normal((4 * 4, 6)).astype(np.float32)

    def line(v, vc, vg, wv):
        grad = jax.grad(lambda t: jnp.sum(
            pc.alltoall(t.reshape(4, -1, 6), "x") * wv.reshape(4, -1, 6)))(vg)
        return (*_pc_and_lax(v, "x", 4, 8), *_pc_and_lax(vc, "x", 4, 8),
                grad)

    res = jax.jit(shard_map(
        line, mesh=jax.make_mesh((4,), ("x",)), in_specs=(P("x"),) * 4,
        out_specs=(P("x"),) * 5))(x, xc, xg, w)
    out = {"x": x, "xc": xc, "xg": xg, "w": w}
    out["f32"], out["f32_lax"], out["c64"], out["c64_lax"], out["grad"] = (
        np.asarray(r) for r in res)

    x2 = rng.standard_normal((8 * 24, 8)).astype(np.float32)

    def grid(v):
        return (*_pc_and_lax(v, "a", 2, 8), *_pc_and_lax(v, "b", 4, 8))

    res = jax.jit(shard_map(
        grid, mesh=jax.make_mesh((2, 4), ("a", "b")),
        in_specs=P(("a", "b")), out_specs=(P(("a", "b")),) * 4))(x2)
    out["x2"] = x2
    out["a"], out["a_lax"], out["b"], out["b_lax"] = (
        np.asarray(r) for r in res)
    return out


def test_plain_alltoall_is_the_direct_kernel_on_a_ring(jax_direct):
    ref = jax_direct
    comm = mt.make_mesh(4, device="cpu")
    for key, width in (("f32", 8), ("c64", 8)):
        src = ref["x" if key == "f32" else "xc"]
        x = torch.from_numpy(src).reshape(4, 4, -1, width)
        got = coll.alltoall_plain(x, comm).numpy().reshape(src.shape)
        assert got.dtype == ref[key].dtype
        assert got.tobytes() == ref[key].tobytes()
        assert got.tobytes() == ref[key + "_lax"].tobytes()


@pytest.mark.parametrize("axis", ["a", "b"])
def test_plain_alltoall_is_the_direct_kernel_on_grid_axes(jax_direct, axis):
    ref = jax_direct
    n = {"a": 2, "b": 4}[axis]
    comm = MeshComm(("a", "b"), (2, 4), device="cpu").sub(axis)
    x = torch.from_numpy(ref["x2"]).reshape(2, 4, n, -1, 8)
    got = mt.alltoall(x, comm=comm).numpy().reshape(ref["x2"].shape)
    assert got.tobytes() == ref[axis].tobytes()
    assert got.tobytes() == ref[axis + "_lax"].tobytes()


def test_alltoall_gradient_matches_jax_grad(jax_direct):
    ref = jax_direct
    comm = mt.make_mesh(4, device="cpu")
    x = torch.from_numpy(ref["xg"]).reshape(4, 4, 1, 6).requires_grad_()
    w = torch.from_numpy(ref["w"]).reshape(4, 4, 1, 6)
    y = mt.alltoall(x, comm=comm)
    assert y.grad_fn is not None
    (y * w).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy().reshape(16, 6), ref["grad"])
