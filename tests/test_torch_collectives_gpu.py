"""The hop and fused-ring CUDA kernels against their plain versions, on the
card.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_collectives_gpu.py

Every comparison is bit for bit: the hop moves bytes, and the fused ring
keeps the association of its plain version (``topo.simulate_ring_sum``'s).
"""

import pytest
import torch

from mpi4jax_tpu_torch import allreduce, halo_exchange, make_mesh
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.parallel.grid import ProcessGrid

DTYPES = [torch.float32, torch.float64, torch.int32, torch.bfloat16,
          torch.complex64, torch.uint8]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rand(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_complex or dtype.is_floating_point:
        x = torch.randn(shape, generator=g,
                        dtype=dtype if dtype.is_complex else torch.float32)
    else:
        x = torch.randint(0, 120, shape, generator=g)
    return x.to(dtype).to(dev)


def _same_bits(a, b):
    a = a.detach().contiguous().reshape(-1)
    b = b.detach().contiguous().reshape(-1)
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _vs_plain(fn, *args):
    got = fn(*args)
    with coll.use_plain():
        ref = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda"
        assert _same_bits(g, r)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("local", [(5,), (3, 7), (33,)])
def test_hop_kernel_matches_plain(cuda, n, dtype, local):
    comm = make_mesh(n, device=cuda)
    x = _rand((n,) + local, dtype, cuda, n)
    y = _rand((n,) + local, dtype, cuda, n + 1)
    before = coll.LAUNCHES["hop"]
    _vs_plain(coll.ring_shift, x, comm, 1)
    _vs_plain(coll.ring_shift, x, comm, -1)
    _vs_plain(coll.ring_shift2, x, y, comm)
    _vs_plain(coll.exchange, x, comm, [c ^ 1 for c in range(n)])
    (got,) = _vs_plain(coll.hop, (x,), [(r + 1,) for r in range(n - 1)]
                       + [(None,)])
    assert _same_bits(got[0], torch.zeros_like(got[0]))
    assert coll.LAUNCHES["hop"] == before + 5


@pytest.mark.gpu
def test_hop_kernel_on_grid_axes(cuda):
    grid = ProcessGrid((2, 4), device=cuda)
    a = _rand((2, 4, 3, 1, 11), torch.float32, cuda, 1)
    b = _rand((2, 4, 3, 1, 11), torch.float32, cuda, 2)
    for d in range(2):
        _vs_plain(coll.ring_shift2, a, b, grid.axis_comm(d))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 4, 8])
@pytest.mark.parametrize("count", [1, 3, 513, 16 * 1024 + 37])
def test_fused_ring_kernel_matches_plain(cuda, n, count):
    rows = _rand((n, count), torch.float32, cuda, count)
    before = coll.LAUNCHES["fused_ring"]
    got = coll.fused_ring_kernel(rows)
    torch.cuda.synchronize()
    assert coll.LAUNCHES["fused_ring"] == before + 1
    assert _same_bits(got, coll.fused_ring_allreduce_plain(rows))
    assert _same_bits(got, got[:1].expand_as(got))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16, torch.int32, torch.int64,
                                   torch.complex64])
def test_fused_ring_kernel_dtypes(cuda, dtype):
    comm = make_mesh(4, device=cuda)
    x = _rand((4, 1000), dtype, cuda, 3)
    _vs_plain(coll.fused_ring_allreduce_sum, x, comm)


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
@pytest.mark.parametrize("n", [64, 65])
def test_hop_past_64_pairs_matches_plain(cuda, n):
    """One hop launch holds 64 (rank, payload) pairs; a larger hop takes
    several launches, and a hop of 64 or fewer stays one."""
    comm = make_mesh(n, device=cuda)
    x = _rand((n, 37), torch.float32, cuda, n)
    y = _rand((n, 5), torch.bfloat16, cuda, n + 1)
    before = coll.LAUNCHES["hop"]
    _vs_plain(coll.ring_shift, x, comm, 1)
    assert coll.LAUNCHES["hop"] == before + (1 if n <= 64 else 2)
    before = coll.LAUNCHES["hop"]
    _vs_plain(coll.ring_shift_n, (x, y), comm, 1)
    assert coll.LAUNCHES["hop"] == before + -(-2 * n // 64)
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
