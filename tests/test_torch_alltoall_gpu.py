"""The alltoall CUDA kernel against its plain version, on the card.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_alltoall_gpu.py

Every comparison is bit for bit: the kernel moves bytes, and the fronts and
the spectral solve around it run the same PyTorch calls on either route.
"""

import pytest
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.models import spectral
from mpi4jax_tpu_torch.ops import _collectives as coll

DTYPES = [torch.float32, torch.float64, torch.bfloat16, torch.complex64,
          torch.int8, torch.uint8, torch.bool]
# rows of 1 element, odd byte counts, counts that are no multiple of 16,
# 16-byte multiples, more than one 64 KiB chunk, and empty rows
RESTS = [(), (5,), (3, 7), (1030,), (9000, 3), (0,)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rand(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        x = torch.randint(0, 2, shape, generator=g).bool()
    elif dtype.is_complex or dtype.is_floating_point:
        x = torch.randn(shape, generator=g,
                        dtype=dtype if dtype.is_complex else torch.float32)
    else:
        x = torch.randint(-100, 100, shape, generator=g)
    return x.to(dtype).to(dev)


def _same_bits(a, b):
    a = a.detach().contiguous().reshape(-1)
    b = b.detach().contiguous().reshape(-1)
    return a.dtype == b.dtype and torch.equal(a.view(torch.uint8),
                                              b.view(torch.uint8))


def _vs_plain(fn, *args):
    got = fn(*args)
    with coll.use_plain():
        ref = fn(*args)
    assert got.device.type == "cuda"
    assert _same_bits(got, ref)
    return got


def _comms(dev):
    grid = mt.ProcessGrid((2, 4), device=dev)
    return ([mt.make_mesh(n, device=dev) for n in (2, 3, 4, 8)]
            + [grid.axis_comm(0), grid.axis_comm(1)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rest", RESTS)
def test_alltoall_kernel_matches_plain(cuda, dtype, rest):
    for i, comm in enumerate(_comms(cuda)):
        x = _rand(comm.layout_shape + (comm.size(),) + rest, dtype, cuda, i)
        before = coll.LAUNCHES["alltoall"]
        _vs_plain(coll.alltoall, x, comm)
        torch.cuda.synchronize()
        empty = x.numel() == 0
        assert coll.LAUNCHES["alltoall"] == before + (0 if empty else 1)


@pytest.mark.gpu
def test_alltoall_kernel_on_64_ranks(cuda):
    """4096 (rank, row) pairs in one launch: no cap below a 64-rank mesh."""
    comm = mt.make_mesh(64, device=cuda)
    x = _rand((64, 64, 3), torch.float32, cuda, 5)
    got = _vs_plain(coll.alltoall, x, comm)
    assert torch.equal(got, x.transpose(0, 1))


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
