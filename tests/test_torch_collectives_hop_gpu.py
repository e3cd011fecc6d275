"""The hop kernel at n = 8 and past 64 pairs, its zero fill, the halo on
large grids and the allreduce's arms, against their plain versions, on
the card (marked ``gpu``; imports no JAX; the helpers and the hop at n = 2
and 4 are in ``tests/test_torch_collectives_gpu.py``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_collectives_hop_gpu.py
"""

import pytest
import torch

from mpi4jax_tpu_torch import allreduce, halo_exchange, make_mesh
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.parallel.grid import ProcessGrid
from test_torch_collectives_gpu import (DTYPES, HOP_LOCALS,  # noqa: F401
                                        _rand, _same_bits, _vs_plain,
                                        check_hop, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("local", HOP_LOCALS)
def test_hop_kernel_matches_plain(cuda, n, dtype, local):
    check_hop(cuda, n, dtype, local)


@pytest.mark.gpu
@pytest.mark.parametrize("count", [1, 5000, 16 * 1024])
@pytest.mark.parametrize("n", [3, 4, 6])
def test_allreduce_arms_on_the_card(cuda, n, count):
    comm = make_mesh(n, device=cuda)
    x = _rand((n, count), torch.float32, cuda, 4).requires_grad_()
    got = _vs_plain(lambda v: allreduce(v, comm=comm), x)[0]
    assert got.grad_fn is not None
    got.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, float(n)))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 65, 130])
def test_hop_past_64_pairs_matches_plain(cuda, n):
    """A hop of any number of (rank, payload) pairs is one launch."""
    comm = make_mesh(n, device=cuda)
    x = _rand((n, 37), torch.float32, cuda, n)
    y = _rand((n, 5), torch.bfloat16, cuda, n + 1)
    before = coll.LAUNCHES["hop"]
    _vs_plain(coll.ring_shift, x, comm, 1)
    assert coll.LAUNCHES["hop"] == before + 1
    before = coll.LAUNCHES["hop"]
    _vs_plain(coll.ring_shift_n, (x, y), comm, 1)
    assert coll.LAUNCHES["hop"] == before + 1
    _vs_plain(coll.ring_shift_n, (x, y), comm, -3)
    _vs_plain(coll.ring_shift2, x, y, comm)
    _vs_plain(lambda v: allreduce(v, comm=comm), x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(6, 6), (8, 8)])
def test_halo_exchange_on_large_grids(cuda, shape):
    grid = ProcessGrid(shape, device=cuda)
    f = _rand(shape + (3, 10, 12), torch.float32, cuda, 5)
    for periodic in (True, False):
        _vs_plain(lambda g: halo_exchange(g, grid, periodic=periodic), f)


@pytest.mark.gpu
def test_hop_zero_fill_is_the_one_launch(cuda):
    """A hop that leaves blocks untargeted writes their zeros in its own
    launch: the profiler sees one kernel, the hop's, and no memset."""
    from torch.profiler import ProfilerActivity, profile

    n = 8
    x = _rand((n, 3, 37), torch.float32, cuda, 24)
    y = _rand((n, 5), torch.bfloat16, cuda, 25)
    # payload 0 an open chain, payload 1 a swap of two ranks
    table = [(r + 1 if r < n - 1 else None, None) for r in range(n)]
    table[0], table[n - 1] = (1, n - 1), (None, 0)
    table = coll._check_table(table, 2)
    _vs_plain(coll._hop_apply, table, (x, y))  # makes the plan
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = coll._hop_apply(table, (x, y))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "hop_kernel" in names[0], names
    assert not _same_bits(got[0], torch.zeros_like(got[0]))
    assert _same_bits(got[0][0], torch.zeros_like(got[0][0]))
    assert _same_bits(got[1][1:n - 1], torch.zeros_like(got[1][1:n - 1]))
