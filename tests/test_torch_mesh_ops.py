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


def test_gradient_of_the_fused_ring_is_the_fused_ring():
    n, count = 4, 16 * 1024 + 37
    comm = mt.make_mesh(n, device="cpu")
    x = torch.zeros(n, count, requires_grad=True)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n, count)).astype(np.float32))
    coll.allreduce_sum(x, comm).backward(g)
    want = simulate_ring_sum(list(g.numpy()))
    assert x.grad[0].numpy().tobytes() == want.tobytes()


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
