"""The alltoall CUDA kernel's paths, its backward, the fronts and the
spectral solve against their plain versions, on the card (marked ``gpu``;
imports no JAX; the helpers and the dtype sweep are in
``tests/test_torch_alltoall_gpu.py``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_alltoall_fronts_gpu.py
"""

import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.models import spectral
from mpi4jax_tpu_torch.ops import _collectives as coll
from test_torch_alltoall_gpu import (_comms, _rand, _same_bits,  # noqa: F401
                                     _vs_plain, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("rest,dtype", [
    ((40000,), torch.float32),  # the bulk path, a short last piece
    ((8192,), torch.float32),   # the bulk path, one 32 KiB piece a row
    ((40001,), torch.int8),     # past a piece, no multiple of 16 bytes
    ((8191,), torch.float32),   # just under a piece
])
def test_alltoall_kernel_paths_match_plain(cuda, rest, dtype):
    """Rows on either side of the bulk path's conditions (16-byte multiples
    of at least one 32 KiB piece), and the same rows 4 bytes off 16."""
    comm = mt.make_mesh(4, device=cuda)
    x = _rand((4, 4) + rest, dtype, cuda, 8)
    _vs_plain(coll.alltoall, x, comm)
    skip = 4 // x.element_size()  # elements in 4 bytes
    buf = torch.empty(x.numel() + skip, dtype=dtype, device=cuda)
    y = buf[skip:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4
    _vs_plain(coll.alltoall, y, comm)


@pytest.mark.gpu
def test_alltoall_kernel_past_65535_pairs(cuda):
    """257 ranks: 66,049 (rank, row) pairs in one launch, past the grid's
    65,535 rows, so blocks stride over the pairs."""
    comm = mt.make_mesh(257, device=cuda)
    x = _rand((257, 257, 2), torch.float32, cuda, 9)
    before = coll.LAUNCHES["alltoall"]
    got = _vs_plain(coll.alltoall, x, comm)
    assert coll.LAUNCHES["alltoall"] == before + 1
    assert torch.equal(got, x.transpose(0, 1))


@pytest.mark.gpu
def test_alltoall_kernel_backward(cuda):
    comm = mt.ProcessGrid((2, 4), device=cuda).axis_comm(1)
    x = _rand((2, 4, 4, 7), torch.float32, cuda, 6).requires_grad_()
    w = _rand((2, 4, 4, 7), torch.float32, cuda, 7)
    before = coll.LAUNCHES["alltoall"]
    (mt.alltoall(x, comm=comm) * w).sum().backward()
    assert coll.LAUNCHES["alltoall"] == before + 2
    got = x.grad
    x.grad = None
    with coll.use_plain():
        (mt.alltoall(x, comm=comm) * w).sum().backward()
    assert _same_bits(got, x.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 4, 8])
def test_fronts_match_plain(cuda, n):
    comm = mt.make_mesh(n, device=cuda)
    x = _rand((n, n, 5), torch.float32, cuda, n)
    flags = _rand((n, 3), torch.bool, cuda, n + 1)
    before = coll.LAUNCHES["alltoall"]
    _vs_plain(lambda v: mt.scatter(v, n - 1, comm=comm), x)
    assert coll.LAUNCHES["alltoall"] == before + 1
    _vs_plain(lambda v: mt.bcast(v, 1, comm=comm), x)
    _vs_plain(lambda v: mt.bcast(v, 0, comm=comm), flags)
    _vs_plain(lambda v: mt.reduce(v, mt.SUM, 2, comm=comm), x)
    _vs_plain(lambda v: mt.reduce(v, mt.MAX, 0, comm=comm), x)
    _vs_plain(lambda v: mt.gather(v, 0, comm=comm), x)
    assert mt.barrier(comm=comm) is None


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 8])
def test_spectral_solve_matches_plain(cuda, n):
    comm = mt.make_mesh(n, device=cuda)
    size = 32
    g = torch.arange(size, dtype=torch.float64, device=cuda) * (
        2 * torch.pi / size)
    u = (torch.sin(g)[:, None, None] * torch.cos(2 * g)[None, :, None]
         * torch.sin(g)[None, None, :]).reshape(n, size // n, size, size)
    f = (-6 * u).float()
    before = coll.LAUNCHES["alltoall"]
    got = _vs_plain(lambda v: spectral.poisson_solve(
        v, comm=comm, shape=(size,) * 3), f)
    assert coll.LAUNCHES["alltoall"] == before + 2
    assert float((got - u.float()).abs().max()) < 1e-3
