"""Kernels 5, 6 and 7 (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) and the
flash route of ring attention, forward and backward, against their plain
versions, on the card.

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
is rounded once on both routes.  The backward's ``(dq, dk, dv)`` are held
to ``_flash_check.TOL_BWD``, each component over the noise scale of the
rounding its sum goes through (``bwd_noise``, ``ring_bwd_noise``), between
the sound kernels' readings and those of planted faults.
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
    """The flash route's backward runs on the card: n launches each of
    kernels 6 and 7 and n hops at n = 2, finite gradients."""
    comm = make_mesh(2, device=cuda)
    q = torch.randn(2, 1, 64, 2, 16, device=cuda, requires_grad=True)
    before = (flash.LAUNCHES["flash_bwd_dq"], flash.LAUNCHES["flash_bwd_dkv"],
              coll.LAUNCHES["hop"])
    out = ring_attention(q, q, q, comm=comm, causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (flash.LAUNCHES["flash_bwd_dq"], flash.LAUNCHES["flash_bwd_dkv"],
            coll.LAUNCHES["hop"]) == (before[0] + 2, before[1] + 2,
                                      before[2] + 1 + 2)
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())


@pytest.mark.gpu
def test_plain_route_backward_launches_nothing(cuda):
    """Under ``use_plain()`` the backward, which autograd runs on its
    device thread, takes the plain versions too."""
    comm = make_mesh(2, device=cuda)
    q = torch.randn(2, 1, 64, 2, 16, device=cuda, requires_grad=True)
    before = (dict(flash.LAUNCHES), dict(coll.LAUNCHES))
    with coll.use_plain():
        ring_attention(q, q, q, comm=comm, causal=True).sum().backward()
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, coll.LAUNCHES) == before
    assert bool(torch.isfinite(q.grad).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", chk.HEAD_DIMS)
def test_bwd_kernels_match_plain_at_the_edges(cuda, dtype, d):
    count = 0
    for (tag, q, k, v, do, lse, delta, qo, ko, scale,
         causal) in chk.bwd_cases(cuda, dtypes=(dtype,), head_dims=(d,)):
        before = (flash.LAUNCHES["flash_bwd_dq"],
                  flash.LAUNCHES["flash_bwd_dkv"])
        got = flash.flash_bwd_block(q, k, v, do, lse, delta, qo, ko,
                                    scale=scale, causal=causal)
        torch.cuda.synchronize()
        assert (flash.LAUNCHES["flash_bwd_dq"],
                flash.LAUNCHES["flash_bwd_dkv"]) == (before[0] + 1,
                                                     before[1] + 1)
        ref = flash.flash_bwd_block_plain(q, k, v, do, lse, delta, qo, ko,
                                          scale=scale, causal=causal)
        noise = chk.bwd_noise(q, k, v, do, lse, delta, qo, ko, scale=scale,
                              causal=causal)
        errs = chk.bwd_errors(got, ref, noise)
        assert chk.within_bwd(errs, dtype), (tag, errs)
        count += 1
    assert count


@pytest.mark.gpu
def test_bwd_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(2, 8, 48, device=cuda, dtype=torch.bfloat16)
    rows = torch.zeros(2, 8, 1, device=cuda)
    offs = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    for fn in (flash._flash_bwd_dq_kernel, flash._flash_bwd_dkv_kernel):
        with pytest.raises(ValueError, match="head sizes"):
            fn(q, q, q, q, rows, rows, offs, scale=1.0, causal=False)
        x = torch.zeros(2, 8, 64, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(TypeError, match="takes q, k, v, dO"):
            fn(x, x, x, x.float(), rows, rows, offs, scale=1.0, causal=False)
        with pytest.raises(ValueError, match="lse must be"):
            fn(x, x, x, x, rows.double(), rows, offs, scale=1.0,
               causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_route_gradient_matches_plain_route(cuda, n, dtype):
    shape = (2, 512, 4, 64)
    comm = make_mesh(n, device=cuda)
    q, k, v = (ring_bench.shard(x, n).requires_grad_()
               for x in ring_bench.make_qkv(shape, dtype, cuda, seed=n))
    do = ring_bench.shard(ring_bench.make_qkv(shape, dtype, cuda,
                                              seed=n + 10)[0], n)
    before = (flash.LAUNCHES["flash_bwd_dq"], flash.LAUNCHES["flash_bwd_dkv"],
              coll.LAUNCHES["hop"])
    ring_attention(q, k, v, comm=comm, causal=True).backward(do)
    torch.cuda.synchronize()
    # forward: n - 1 hops; backward: n (none at n = 1)
    hops = n - 1 + (n if n > 1 else 0)
    assert (flash.LAUNCHES["flash_bwd_dq"], flash.LAUNCHES["flash_bwd_dkv"],
            coll.LAUNCHES["hop"]) == (before[0] + n, before[1] + n,
                                      before[2] + hops)
    # the f32 gradients within TOL_BWD of the plain route's, and the entry
    # point's gradients those f32 gradients cast, dq through the
    # prescale's chain rule
    res = chk.ring_grad_check(q.detach(), k.detach(), v.detach(), do, comm,
                              True, (q.grad, k.grad, v.grad))
    assert res["within"] and res["grads_are_f32_cast"], res


@pytest.mark.gpu
def test_auto_with_a_tensor_scale_raises_on_the_card(cuda):
    comm = make_mesh(2, device=cuda)
    q = torch.randn(2, 1, 16, 2, 16, device=cuda)
    scale = torch.tensor(0.25, device=cuda)
    with pytest.raises(ValueError, match="impl='xla'"):
        ring_attention(q, q, q, comm=comm, scale=scale)
    out = ring_attention(q, q, q, comm=comm, scale=scale, impl="xla")
    assert out.shape == q.shape


def _qkv(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(shape, generator=g) * 0.4).to(dtype).to(device)
            for _ in range(4)]


def _bwd_rows(q, k, v, do, offs):
    """lse and delta of the forward of one block, as the ring hands them
    to kernels 6 and 7 (a row that sees no key takes lse = m)."""
    o, m, l = flash.flash_fwd_block_plain(q, k, v, offs[:, 0], offs[:, 1],
                                          scale=1.0, causal=True)
    live = l > 0
    lse = m + torch.log(torch.where(live, l, 1.0))
    delta = (do.float() * o / torch.where(live, l, 1.0)).sum(-1, keepdim=True)
    return lse, delta


@pytest.mark.gpu
def test_wgmma_kernels_on_two_streams_at_once(cuda):
    """Kernels 5, 6 and 7 launched on two streams at once give, bit for
    bit, what each gives alone: no device state is shared between
    launches."""
    bh, t, d = 8, 640, 128
    sets = []
    for seed in (1, 2):
        q, k, v, do = _qkv((bh, t, d), torch.bfloat16, cuda, seed)
        offs = torch.tensor([[t, t * (seed - 1)]] * bh, dtype=torch.int32,
                            device=cuda)
        sets.append((q, k, v, do, offs, *_bwd_rows(q, k, v, do, offs)))

    def run(q, k, v, do, offs, lse, delta):
        fwd = flash._flash_fwd_kernel(q, k, v, offs, scale=1.0, causal=True)
        dq = flash._flash_bwd_dq_kernel(q, k, v, do, lse, delta, offs,
                                        scale=1.0, causal=True)
        dkv = flash._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, offs,
                                          scale=1.0, causal=True)
        return (*fwd, dq, *dkv)

    alone = [run(*x) for x in sets]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in sets]
    together = [None, None]
    for _ in range(3):
        for i, (x, stream) in enumerate(zip(sets, streams)):
            with torch.cuda.stream(stream):
                together[i] = run(*x)
        torch.cuda.synchronize()
        for a, b in zip(alone, together):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_wgmma_kernels_take_inputs_off_16_bytes(cuda):
    """An input 8 bytes off a 16-byte boundary is copied into alignment
    before its tensor map is made: the result is that of the aligned
    input, bit for bit."""
    bh, t, d = 3, 200, 64
    q, k, v, do = _qkv((bh, t, d), torch.bfloat16, cuda, 3)
    offs = torch.zeros(bh, 2, dtype=torch.int32, device=cuda)
    lse, delta = _bwd_rows(q, k, v, do, offs)

    def off16(x):
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)
        y = buf[4:4 + x.numel()].view(x.shape)
        y.copy_(x)
        assert y.data_ptr() % 16 == 8
        return y

    bwd = (q, k, v, do, lse, delta, offs)
    for fn, args in ((flash._flash_fwd_kernel, (q, k, v, offs)),
                     (flash._flash_bwd_dq_kernel, bwd),
                     (flash._flash_bwd_dkv_kernel, bwd)):
        ref = fn(*args, scale=1.0, causal=True)
        moved = [off16(x) if x.dtype == torch.bfloat16 else x for x in args]
        got = fn(*moved, scale=1.0, causal=True)
        torch.cuda.synchronize()
        if isinstance(ref, torch.Tensor):
            got, ref = (got,), (ref,)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wgmma_kernels_at_rows_narrower_than_the_swizzle(cuda, dtype):
    """D = 16: 32-byte rows, a quarter of the 128-byte swizzle span, on the
    32-byte swizzle; kernels 5, 6 and 7 at ring offsets (the diagonal step
    and the step below it) over several 128-row blocks, within ``TOL`` and
    ``TOL_BWD``."""
    bh, t, d = 6, 700, 16
    q, k, v, do = _qkv((bh, t, d), dtype, cuda, 4)
    for q_off, k_off in ((t, t), (2 * t, t)):
        offs = torch.tensor([[q_off, k_off]] * bh, dtype=torch.int32,
                            device=cuda)
        got = flash._flash_fwd_kernel(q, k, v, offs, scale=1.0, causal=True)
        ref = flash.flash_fwd_block_plain(q, k, v, offs[:, 0], offs[:, 1],
                                          scale=1.0, causal=True)
        errs = chk.errors(got, ref, chk.noise(q, k, v, offs[:, 0],
                                              offs[:, 1], scale=1.0,
                                              causal=True))
        assert chk.within(errs, dtype), (q_off, k_off, errs)
        lse, delta = _bwd_rows(q, k, v, do, offs)
        dq = flash._flash_bwd_dq_kernel(q, k, v, do, lse, delta, offs,
                                        scale=1.0, causal=True)
        dk, dv = flash._flash_bwd_dkv_kernel(q, k, v, do, lse, delta, offs,
                                             scale=1.0, causal=True)
        ref = flash.flash_bwd_block_plain(q, k, v, do, lse, delta,
                                          offs[:, 0], offs[:, 1], scale=1.0,
                                          causal=True)
        noise = chk.bwd_noise(q, k, v, do, lse, delta, offs[:, 0],
                              offs[:, 1], scale=1.0, causal=True)
        errs = chk.bwd_errors((dq, dk, dv), ref, noise)
        assert chk.within_bwd(errs, dtype), (q_off, k_off, errs)
