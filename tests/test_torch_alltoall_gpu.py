"""The alltoall CUDA kernel against its plain version, on the card.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_alltoall_gpu.py

Every comparison is bit for bit: the kernel moves bytes, and the fronts and
the spectral solve around it run the same PyTorch calls on either route.

The kernel on every dtype and row shape and at 64 ranks is here (at most
45 cases); its vector and element paths, past 65535 pairs, its backward,
the fronts and the spectral solve in
``tests/test_torch_alltoall_fronts_gpu.py``, which imports the helpers
from here.
"""

import pytest
import torch

import mpi4jax_tpu_torch as mt
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
