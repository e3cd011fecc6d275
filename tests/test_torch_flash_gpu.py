"""Kernel 5 (``csrc/flash_fwd.cu``) and the flash route of ring attention
against their plain versions, on the card.

Marked ``gpu``: without a card every test skips.  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_flash_gpu.py

Tolerances, with their reasons, are those of
``mpi4jax_tpu_torch/ops/_flash_check.py``: the normalized output's error in
each component is measured over that component's noise scale
``sqrt(sum_j p_j^2 v_jd^2) / l``.  f32 inputs differ from the plain version
only by the order of summation and ``expf``; bf16 and fp16 also by the
rounding of p to the input type against a running maximum rather than the
row's, which spreads the difference by about ``u sqrt(2/3)`` of the scale
(u = 2^-9 and 2^-12).  Each limit lies between the sound kernel's worst
reading and the readings of planted faults
(``mpi4jax_tpu_torch.benchmarks.flash_tolerance``).  The ring's f32 output,
before its cast, is held to the plain route's with the same limits: each p
is rounded once on both routes.
"""

import pytest
import torch

from mpi4jax_tpu_torch import make_mesh
from mpi4jax_tpu_torch.benchmarks import ring_attention as ring_bench
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.ops import _flash_check as chk
from mpi4jax_tpu_torch.ops import flash
from mpi4jax_tpu_torch.parallel.ring import ring_attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", chk.HEAD_DIMS)
def test_kernel_matches_plain_at_the_edges(cuda, dtype, d):
    count = 0
    for tag, q, k, v, qo, ko, scale, causal in chk.cases(
            cuda, dtypes=(dtype,), head_dims=(d,)):
        before = flash.LAUNCHES["flash_fwd"]
        got = flash.flash_fwd_block(q, k, v, qo, ko, scale=scale,
                                    causal=causal)
        torch.cuda.synchronize()
        assert flash.LAUNCHES["flash_fwd"] == before + 1
        ref = flash.flash_fwd_block_plain(q, k, v, qo, ko, scale=scale,
                                          causal=causal)
        errs = chk.errors(got, ref, chk.noise(q, k, v, qo, ko, scale=scale,
                                              causal=causal))
        assert chk.within(errs, dtype), (tag, errs)
        count += 1
    assert count


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 48, device=cuda, dtype=torch.bfloat16)
    offs = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head sizes"):
        flash._flash_fwd_kernel(q, q, q, offs, scale=1.0, causal=False)
    q = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="kernel 5 takes"):
        flash._flash_fwd_kernel(q, q, q, offs, scale=1.0, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_route_matches_plain_route(cuda, n, dtype):
    shape = (2, 512, 4, 64)
    comm = make_mesh(n, device=cuda)
    q, k, v = (ring_bench.shard(x, n)
               for x in ring_bench.make_qkv(shape, dtype, cuda, seed=n))
    before = (flash.LAUNCHES["flash_fwd"], coll.LAUNCHES["hop"])
    out = ring_attention(q, k, v, comm=comm, causal=True)
    torch.cuda.synchronize()
    assert flash.LAUNCHES["flash_fwd"] == before[0] + n
    assert coll.LAUNCHES["hop"] == before[1] + n - 1
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    got, ref = chk.ring_outputs(q, k, v, comm, True)
    assert torch.equal(got.to(dtype), out)
    err = chk.scaled_error(got, ref, chk.ring_noise(q, k, v, comm, True))
    assert err <= chk.TOL[dtype]["o"], err


@pytest.mark.gpu
def test_ring_route_backward_raises(cuda):
    comm = make_mesh(2, device=cuda)
    q = torch.randn(2, 1, 64, 2, 16, device=cuda, requires_grad=True)
    out = ring_attention(q, q, q, comm=comm, causal=True)
    with pytest.raises(NotImplementedError, match="kernels 6 and 7"):
        out.sum().backward()


@pytest.mark.gpu
def test_auto_with_a_tensor_scale_raises_on_the_card(cuda):
    comm = make_mesh(2, device=cuda)
    q = torch.randn(2, 1, 16, 2, 16, device=cuda)
    scale = torch.tensor(0.25, device=cuda)
    with pytest.raises(ValueError, match="impl='xla'"):
        ring_attention(q, q, q, comm=comm, scale=scale)
    out = ring_attention(q, q, q, comm=comm, scale=scale, impl="xla")
    assert out.shape == q.shape
