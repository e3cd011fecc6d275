"""The port's token API held against the JAX package's, on the CPU.

- ``tests/test_token_compat.py``'s three cases on the port's ``spmd``;
- every op of ``compat.token_api`` on a mesh comm against the JAX
  ``token_api`` on the 8-device CPU mesh, on the same seeded inputs: bit
  for bit where the tokenless ops are (data movement, MAX), SUM within
  ``RTOL`` of the sum of the magnitudes (the two packages associate
  differently, as in ``tests/test_torch_mesh_ops.py``); and every tokened
  result bit for bit the port's tokenless call;
- a tokened SUM allreduce's gradient against the tokenless one;
- a 2-rank world job (this file is the ranks' program) whose token chain
  gives bit for bit the tokenless run's results, with
  ``explicit_token_ordering()`` warning nothing on its eager chain.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.compat import token_api
from mpi4jax_tpu_torch.ops import _dispatch

N = 8
LOCAL = (5,)
RTOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- tests/test_token_compat.py's cases on the port ---------------------------

def test_token_chain_matches_reference_style():
    comm = mt.make_mesh(N, device="cpu")
    x = torch.arange(N, dtype=torch.float32).reshape(N, 1)

    def step(v):
        token = token_api.create_token(v)
        a, token = token_api.allreduce(v, op=mt.SUM, token=token)
        b, token = token_api.sendrecv(a, shift=1, token=token)
        token = token_api.barrier(token=token)
        c, token = token_api.allgather(b, token=token)
        return c.sum(dim=(-2, -1))[:, None] + b

    out = mt.spmd(step, comm=comm)(x)
    s = np.sum(np.arange(N))
    np.testing.assert_allclose(out.numpy(), np.full((N, 1), N * s + s))


def test_token_api_starts_chain_without_token():
    comm = mt.make_mesh(N, device="cpu")

    def step(v):
        res, token = token_api.allreduce(v, op=mt.SUM)
        assert token is not None
        assert token.dtype == torch.uint32 and token.dim() == 0
        return res

    out = mt.spmd(step, comm=comm)(torch.ones(N, 1))
    np.testing.assert_allclose(out.numpy(), N)


def test_all_ops_present():
    from mpi4jax_tpu.compat import token_api as jax_token_api

    for name in (
        "allgather allreduce alltoall barrier bcast gather recv reduce "
        "scan scatter send sendrecv create_token"
    ).split():
        assert hasattr(token_api, name), name
    assert sorted(token_api.__all__) == sorted(jax_token_api.__all__)


# -- every op against the JAX token API ---------------------------------------

OPS = ("allreduce_sum", "allreduce_max", "allgather", "alltoall", "bcast",
       "gather", "reduce_sum", "scan_sum", "scatter", "sendrecv")
ROOT = 3


def _inputs():
    rng = np.random.default_rng(16)
    return {"x": rng.standard_normal((N,) + LOCAL).astype(np.float32),
            "rows": rng.standard_normal((N, N) + LOCAL).astype(np.float32)}


def _port_chain(comm, x, rows, token):
    """Each op of the token API once, threading ``token`` (None: the
    tokenless fronts)."""
    def call(fn, *args, **kw):
        if token is None:
            return getattr(mt, fn.__name__)(*args, comm=comm, **kw)
        out, tok = fn(*args, comm=comm, token=token, **kw)
        assert tok.dtype == torch.uint32 and tok.dim() == 0
        return out

    return {
        "allreduce_sum": call(token_api.allreduce, x, op=mt.SUM),
        "allreduce_max": call(token_api.allreduce, x, op=mt.MAX),
        "allgather": call(token_api.allgather, x),
        "alltoall": call(token_api.alltoall, rows),
        "bcast": call(token_api.bcast, x, ROOT),
        "gather": call(token_api.gather, x, ROOT),
        "reduce_sum": call(token_api.reduce, x, op=mt.SUM, root=ROOT),
        "scan_sum": call(token_api.scan, x, op=mt.SUM),
        "scatter": call(token_api.scatter, rows, ROOT),
        "sendrecv": call(token_api.sendrecv, x, shift=1),
    }


@pytest.fixture(scope="module")
def jax_token_results():
    """The JAX token API's result of each op, threaded as one chain in one
    ``spmd`` call on the 8-device CPU mesh."""
    import jax
    import mpi4jax_tpu as m4j
    from mpi4jax_tpu.compat import token_api as jta

    inp = _inputs()

    def f(x, rows):
        tok = jta.create_token(x)
        out = {}
        out["allreduce_sum"], tok = jta.allreduce(x, op=m4j.SUM, token=tok)
        out["allreduce_max"], tok = jta.allreduce(x, op=m4j.MAX, token=tok)
        out["allgather"], tok = jta.allgather(x, token=tok)
        out["alltoall"], tok = jta.alltoall(rows, token=tok)
        out["bcast"], tok = jta.bcast(x, ROOT, token=tok)
        out["gather"], tok = jta.gather(x, ROOT, token=tok)
        out["reduce_sum"], tok = jta.reduce(x, op=m4j.SUM, root=ROOT,
                                            token=tok)
        out["scan_sum"], tok = jta.scan(x, op=m4j.SUM, token=tok)
        out["scatter"], tok = jta.scatter(rows, ROOT, token=tok)
        out["sendrecv"], tok = jta.sendrecv(x, shift=1, token=tok)
        tok = jta.barrier(token=tok)
        return out

    res = jax.jit(m4j.spmd(f, mesh=m4j.make_mesh(N)))(
        inp["x"], inp["rows"].reshape((N * N,) + LOCAL))
    return inp, {k: np.asarray(v) for k, v in res.items()}


@pytest.fixture(scope="module")
def port_results():
    inp = _inputs()
    comm = mt.make_mesh(N, device="cpu")
    x, rows = torch.from_numpy(inp["x"]), torch.from_numpy(inp["rows"])
    plain = _port_chain(comm, x, rows, None)
    tokened = _port_chain(comm, x, rows, mt.create_token(x))
    return ({k: v.numpy() for k, v in plain.items()},
            {k: v.numpy() for k, v in tokened.items()})


@pytest.mark.parametrize("name", OPS)
def test_token_api_op_matches_jax(jax_token_results, port_results, name):
    inp, ref = jax_token_results
    plain, tokened = port_results
    got = tokened[name]
    # the tokened call is bit for bit the tokenless one
    assert got.tobytes() == plain[name].tobytes()
    want = ref[name].reshape(got.shape)
    assert got.dtype == want.dtype
    if name in ("allreduce_sum", "reduce_sum", "scan_sum"):
        tol = RTOL * np.abs(inp["x"]).sum(axis=0, keepdims=True)
        assert np.all(np.abs(got - want) <= tol)
    else:
        assert got.tobytes() == want.tobytes()


def test_send_recv_raise_on_the_mesh_with_a_token():
    comm = mt.make_mesh(N, device="cpu")
    x = torch.ones(N, 2)
    with pytest.raises(NotImplementedError, match="SPMD"):
        token_api.send(x, 0, comm=comm)
    with pytest.raises(NotImplementedError, match="SPMD"):
        token_api.recv(x, 0, comm=comm)


def test_tokened_sum_gradient_is_the_tokenless_one():
    comm = mt.make_mesh(4, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 7)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((4, 7)).astype(np.float32))
    grads = []
    for tokened in (False, True):
        leaf = torch.from_numpy(x).requires_grad_()
        if tokened:
            y, _ = token_api.allreduce(leaf, op=mt.SUM, comm=comm)
        else:
            y = mt.allreduce(leaf, op=mt.SUM, comm=comm)
        (w * y).sum().backward()
        grads.append(leaf.grad.numpy().tobytes())
    assert grads[0] == grads[1]


def test_token_helpers_and_strict_tokens_knob(monkeypatch):
    """The port's token helpers, and ``MPI4JAX_TPU_STRICT_TOKENS``, which
    the JAX package parses for its tracer guard: at every value an eager
    chain with a fresh token mid-chain raises and warns nothing in either
    package, and the port does not read the knob at all."""
    from mpi4jax_tpu.utils import config as jconfig

    x = torch.ones(3)
    tok = _dispatch.create_token(x)
    assert tok.dtype == torch.uint32 and tok.dim() == 0 and int(tok) == 0
    assert _dispatch.attach(x, None) is x
    out, tok2 = _dispatch.attach(x, tok)
    assert out is x and tok2 is tok
    comm = mt.make_mesh(4, device="cpu")
    xs = torch.ones(4, 2)
    for raw in (None, "1", "0", "maybe"):
        if raw is None:
            monkeypatch.delenv("MPI4JAX_TPU_STRICT_TOKENS", raising=False)
        else:
            monkeypatch.setenv("MPI4JAX_TPU_STRICT_TOKENS", raw)
        if raw == "maybe":
            with pytest.raises(ValueError):
                jconfig.flag("MPI4JAX_TPU_STRICT_TOKENS", None)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with mt.explicit_token_ordering():
                _, t = token_api.allreduce(xs, comm=comm)
                token_api.allgather(xs, comm=comm, token=mt.create_token(xs))
                token_api.barrier(comm=comm, token=t)


def test_explicit_token_ordering_sets_the_mode_and_warns_nothing():
    comm = mt.make_mesh(4, device="cpu")
    x = torch.ones(4, 2)
    want = mt.allreduce(x, comm=comm)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with mt.explicit_token_ordering():
            _, tok = token_api.allreduce(x, comm=comm)
            # a fresh token while a chain is live: the JAX guard flags
            # this only on tracers; eager chains run in program order
            _, fresh = token_api.allgather(x, comm=comm,
                                           token=mt.create_token(x))
            got = mt.allreduce(x, comm=comm)  # tokenless inside the mode
    assert torch.equal(got, want)


# -- a 2-rank world job --------------------------------------------------------

def _rank_main():
    """One rank of the world job: the tokenless chain, then the token
    chain inside ``explicit_token_ordering()`` with warnings as errors;
    every result bit for bit; rank 0 prints the verdict."""
    comm = mt.runtime.transport.get_world_comm(device="cpu")
    rank, size = comm.rank(), comm.size()
    torch.set_num_threads(1)
    x = torch.arange(6, dtype=torch.float32) * (rank + 1) + 0.25
    rows = torch.arange(size * 3, dtype=torch.float32).reshape(size, 3) \
        + 10 * rank

    def chain(tok):
        def call(fn, *args, **kw):
            if tok is None:
                return getattr(mt, fn.__name__)(*args, comm=comm, **kw)
            out = fn(*args, comm=comm, token=tok[0], **kw)
            if fn in (token_api.send, token_api.barrier):
                tok[0] = out
                return None
            tok[0] = out[1]
            return out[0]

        out = [call(token_api.allreduce, x, op=mt.SUM),
               call(token_api.allgather, x),
               call(token_api.alltoall, rows),
               call(token_api.bcast, x, 1),
               call(token_api.gather, x, 0),
               call(token_api.reduce, x, op=mt.PROD, root=0),
               call(token_api.scan, x, op=mt.SUM),
               call(token_api.scatter, rows, 1),
               call(token_api.sendrecv, x, source=(rank - 1) % size,
                    dest=(rank + 1) % size)]
        call(token_api.barrier)
        if rank == 0:
            call(token_api.send, x * 3, 1, 7)
        elif rank == 1:
            out.append(call(token_api.recv, torch.empty(6), 0, 7))
        out.append(call(token_api.allreduce, x, op=mt.MAX))
        return out

    plain = chain(None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with mt.explicit_token_ordering():
            tok = [token_api.create_token(x)]
            tokened = chain(tok)
            assert tok[0].dtype == torch.uint32
    same = [a.numpy().tobytes() == b.numpy().tobytes()
            for a, b in zip(plain, tokened)]
    verdicts = mt.allgather(torch.tensor(int(all(same))), comm=comm)
    if rank == 0:
        print(f"token chain: {len(same)} results, bit for bit on every "
              f"rank: {bool(verdicts.all())}", flush=True)
    sys.exit(0 if all(same) else 1)


def test_world_token_chain_matches_the_tokenless_run(monkeypatch, capfd):
    from mpi4jax_tpu_torch.runtime import launch

    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("MPI4JAX_TPU_DISABLE_SHM", "1")
    rc = launch.main(["-n", "2", "--timeout", "60",
                      os.path.abspath(__file__)])
    out = capfd.readouterr().out
    assert rc == 0, out
    assert "bit for bit on every rank: True" in out


if __name__ == "__main__":
    _rank_main()
