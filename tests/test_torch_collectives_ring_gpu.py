"""The fused-ring kernel against its plain version, on the card (marked
``gpu``; imports no JAX; the helpers are in
``tests/test_torch_collectives_gpu.py``):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_collectives_ring_gpu.py

Bit for bit: the fused ring keeps the association of its plain version.
"""

import pytest
import torch

from mpi4jax_tpu_torch import make_mesh
from mpi4jax_tpu_torch.ops import _collectives as coll
from test_torch_collectives_gpu import (_rand, _same_bits,  # noqa: F401
                                        _vs_plain, cuda)


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
