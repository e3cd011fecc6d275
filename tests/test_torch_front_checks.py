"""The port's allreduce and alltoall fronts check ``compression=`` and
``algo=`` as the JAX package's do, on the CPU.

Each case calls the JAX front inside ``spmd`` on a 4-device mesh of the
CPU mesh of ``tests/conftest.py`` and the port's front on a 4-rank mesh of
CPU tensors: both must raise the same exception type, and where a value is
bad both messages name it (where a valid value is refused on the mesh,
both name the argument).
"""

import jax
import numpy as np
import pytest
import torch

import mpi4jax_tpu as m4j

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.utils import algos

N = 4

# (front, keyword arguments, the word both messages must hold)
CASES = [
    ("allreduce", {"compression": "fp8"}, "fp8"),
    ("alltoall", {"compression": "fp8"}, "fp8"),
    ("allreduce", {"algo": "bogus"}, "bogus"),
    ("alltoall", {"algo": "bogus"}, "bogus"),
    ("allreduce", {"algo": "qalltoall"}, "qalltoall"),
    ("alltoall", {"algo": "qring"}, "qring"),
    ("allreduce", {"algo": "ring", "compression": "int8"}, "algo"),
    ("alltoall", {"algo": "ring", "compression": "int8"}, "algo"),
    ("allreduce", {"algo": "ring"}, "algo"),
    ("alltoall", {"algo": "halltoall"}, "algo"),
]


def _jax_error(front, kw):
    mesh = m4j.make_mesh(N)
    fn = getattr(m4j, front)
    x = np.ones((N * N, 3), np.float32)
    with pytest.raises(Exception) as info:
        jax.jit(m4j.spmd(lambda v: fn(v, **kw), mesh=mesh))(x)
    return info.value


def _port_error(front, kw):
    comm = mt.make_mesh(N, device="cpu")
    fn = getattr(mt, front)
    x = torch.ones(N, N, 3)
    with pytest.raises(Exception) as info:
        fn(x, comm=comm, **kw)
    return info.value


@pytest.mark.parametrize("front,kw,word", CASES,
                         ids=[f"{f}-{'-'.join(map(str, kw.values()))}"
                              for f, kw, _ in CASES])
def test_front_raises_as_jax(front, kw, word):
    want = _jax_error(front, kw)
    got = _port_error(front, kw)
    assert type(got) is type(want), (got, want)
    assert word in str(want) and word in str(got), (str(got), str(want))


def test_int8_on_the_mesh_is_not_ported():
    """``compression="int8"`` on a mesh comm: the SUM allreduce runs the
    quantized schedule, as the JAX front does (ones quantize to code 127
    and come back within a quantization step of the exact sum), a non-SUM
    op raises ``NotImplementedError``, and the alltoall refuses it as the
    JAX mesh front does."""
    comm = mt.make_mesh(N, device="cpu")
    x = torch.ones(N, N, 3)
    out = mt.allreduce(x, comm=comm, compression="int8")
    assert out.dtype == x.dtype and out.shape == x.shape
    torch.testing.assert_close(out, torch.full_like(x, N), rtol=0,
                               atol=N / 127)
    with pytest.raises(NotImplementedError, match="op=SUM"):
        mt.allreduce(x, mt.MAX, comm=comm, compression="int8")
    with pytest.raises(NotImplementedError, match="compression"):
        mt.alltoall(x, comm=comm, compression="int8")


def test_algorithm_names_match_jax():
    from mpi4jax_tpu import tune

    assert algos.ALGO_CODES == tune.ALGO_CODES
    assert algos.QUANT_ALGOS == tune.QUANT_ALGOS
    assert algos.A2A_ALGOS == tune.A2A_ALGOS
    for name in list(tune.ALGO_CODES) + ["Recursive-Doubling", "bogus"]:
        for op in (None, "allreduce", "allgather", "alltoall"):
            try:
                want = tune._check_algo(name, op)
            except ValueError as err:
                with pytest.raises(ValueError) as info:
                    algos.check_algo(name, op)
                assert str(info.value) == str(err)
            else:
                assert algos.check_algo(name, op) == want
