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
@pytest.mark.parametrize("n", [2, 3, 4, 8, 65, 130])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16, torch.uint8,
                                   torch.float64])
def test_fused_ring_chunk_boundary_inside_a_vector(cuda, dtype):
    """At n = 3 the chunk length is no multiple of a 16-byte vector, so
    two vectors of a row hold a chunk boundary; aligned rows, so the rest
    takes the vector path."""
    n, count = 3, 16 * 1024 + 16
    per = -(-count // n)
    assert per % (16 // torch.empty(0, dtype=dtype).element_size())
    rows = _rand((n, count), dtype, cuda, 21)
    got = coll.fused_ring_kernel(rows)
    assert _same_bits(got, coll.fused_ring_allreduce_plain(rows))
    assert _same_bits(got, got[:1].expand_as(got))


@pytest.mark.gpu
def test_fused_ring_on_a_misaligned_view(cuda):
    """Rows 4 bytes off a 16-byte boundary take the element path."""
    n, count = 4, 16 * 1024
    flat = _rand((n * count + 1,), torch.float32, cuda, 22)
    rows = flat[1:].view(n, count)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 4
    got = coll.fused_ring_kernel(rows)
    assert _same_bits(got, coll.fused_ring_allreduce_plain(rows))


@pytest.mark.gpu
def test_fused_ring_on_two_streams(cuda):
    """Two launches in flight at once on two streams share no state."""
    xs = [_rand((4, 1 << 22), torch.float32, cuda, 23 + i) for i in range(2)]
    want = [coll.fused_ring_allreduce_plain(x) for x in xs]
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    torch.cuda.synchronize()
    for _ in range(3):
        outs = []
        for x, s in zip(xs, streams):
            with torch.cuda.stream(s):
                outs.append(coll.fused_ring_kernel(x))
        torch.cuda.synchronize()
        for got, ref in zip(outs, want):
            assert _same_bits(got, ref)


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
