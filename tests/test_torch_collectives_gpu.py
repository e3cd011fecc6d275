"""The hop and fused-ring CUDA kernels against their plain versions, on the
card.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_collectives_gpu.py

Every comparison is bit for bit: the hop moves bytes, and the fused ring
keeps the association of its plain version (``topo.simulate_ring_sum``'s).

Three files of at most 45 cases: the hop at n = 2 and 4 here; the hop at
n = 8, past 64 pairs, its zero fill, the halo and the allreduce's arms in
``tests/test_torch_collectives_hop_gpu.py``; the fused ring in
``tests/test_torch_collectives_ring_gpu.py``.  Both import the helpers
from here.
"""

import pytest
import torch

from mpi4jax_tpu_torch import make_mesh
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.parallel.grid import ProcessGrid

DTYPES = [torch.float32, torch.float64, torch.int32, torch.bfloat16,
          torch.complex64, torch.uint8]
HOP_LOCALS = [(5,), (3, 7), (33,)]


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


def check_hop(cuda, n, dtype, local):
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
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("local", HOP_LOCALS)
def test_hop_kernel_matches_plain(cuda, n, dtype, local):
    check_hop(cuda, n, dtype, local)


@pytest.mark.gpu
def test_hop_kernel_on_grid_axes(cuda):
    grid = ProcessGrid((2, 4), device=cuda)
    a = _rand((2, 4, 3, 1, 11), torch.float32, cuda, 1)
    b = _rand((2, 4, 3, 1, 11), torch.float32, cuda, 2)
    for d in range(2):
        _vs_plain(coll.ring_shift2, a, b, grid.axis_comm(d))
