"""The port's flash forward and ring attention held against the JAX
package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
(on the 8-device CPU mesh of ``tests/conftest.py``; the Pallas kernels in
interpret mode) and through the port's on CPU tensors, where kernel 5 and
the hop run their plain versions.

Tolerances are those of the JAX package's own tests: the block against
``_flash_fwd_block`` as ``tests/parallel/test_flash.py`` holds it to dense
attention (m rtol 1e-6; l rtol 1e-5, atol 1e-6; o rtol 1e-5, atol 1e-5; bf16
inputs rtol and atol 2e-2); the ring's output as
``tests/parallel/test_attention.py`` (rtol 2e-4, atol 2e-5) and its
gradient as ``test_attention.py:80`` (rtol 5e-3, atol 5e-4).  The k/v
rotation moves bytes and is held bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpi4jax_tpu as m4j
from mpi4jax_tpu.ops import pallas_collectives as pc
from mpi4jax_tpu.ops.flash import _flash_fwd_block
from mpi4jax_tpu.parallel.ring import ring_attention as jax_ring_attention

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.benchmarks import ring_attention as ring_bench
from mpi4jax_tpu_torch.ops import _collectives as coll
from mpi4jax_tpu_torch.ops import _flash_check as chk
from mpi4jax_tpu_torch.ops import flash
from mpi4jax_tpu_torch.parallel.ring import ring_attention

BH, TQ, TK, D = 3, 32, 48, 16  # tests/parallel/test_flash.py
N = 4
B, T, H = 1, 32, 2  # the ring: T_local = 8


def _block_inputs(seed, dtype=np.float32, scale=0.4):
    rng = np.random.RandomState(seed)
    return [(rng.randn(BH, t, D).astype(np.float32) * scale).astype(dtype)
            for t in (TQ, TK, TK)]


# -- one ring step: the plain version against _flash_fwd_block ---------------

BLOCK_CASES = [
    (False, 0, 0),
    (True, 0, 0),       # diagonal block
    (True, 64, 0),      # k fully in the past
    (True, 16, 32),     # partial overlap, some rows fully masked
]


@pytest.fixture(scope="module")
def jax_blocks():
    """``_flash_fwd_block``'s triples for ``BLOCK_CASES``: one compile per
    causal flag, the offsets traced as in the ring."""
    q, k, v = _block_inputs(1)
    fns = {causal: jax.jit(
        lambda a, b, c, qo, ko, causal=causal: _flash_fwd_block(
            a, b, c, qo, ko, scale=0.25, causal=causal,
            block_q=16, block_k=16, interpret=True))
        for causal in (False, True)}
    return {case: fns[case[0]](q, k, v, jnp.int32(case[1]),
                               jnp.int32(case[2]))
            for case in BLOCK_CASES}


@pytest.mark.parametrize("causal,q_off,k_off", BLOCK_CASES)
def test_block_plain_matches_jax(jax_blocks, causal, q_off, k_off):
    q, k, v = _block_inputs(1)
    o, m, l = jax_blocks[(causal, q_off, k_off)]
    got = flash.flash_fwd_block_plain(
        *map(torch.from_numpy, (q, k, v)), torch.tensor(q_off),
        torch.tensor(k_off), scale=0.25, causal=causal)
    assert all(x.dtype == torch.float32 for x in got)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(m), rtol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(l), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(o), rtol=1e-5,
                               atol=1e-5)


def test_block_plain_bf16_matches_jax():
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16)
               for x in _block_inputs(2, scale=1.0))
    o, m, l = jax.jit(lambda a, b, c: _flash_fwd_block(
        a, b, c, jnp.int32(0), jnp.int32(0), scale=0.25, causal=False,
        block_q=32, block_k=16, interpret=True))(q, k, v)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(torch.bfloat16) for x in (q, k, v))
    got = flash.flash_fwd_block_plain(tq, tk, tv, 0, 0, scale=0.25,
                                      causal=False)
    assert got[0].dtype == torch.float32
    for g, r in zip(got, (o, m, l)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-2,
                                   atol=2e-2)


def test_block_dispatch_and_kernel_checks():
    q, k, v = map(torch.from_numpy, _block_inputs(3))
    offs = torch.tensor([0, 16, 64], dtype=torch.int32)
    got = flash.flash_fwd_block(q, k, v, offs, 0, scale=0.25, causal=True)
    ref = flash.flash_fwd_block_plain(q, k, v, offs,
                                      torch.zeros(3, dtype=torch.int64),
                                      scale=0.25, causal=True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    pairs = torch.zeros(BH, 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="kernel 5 takes"):
        flash._flash_fwd_kernel(q.double(), k.double(), v.double(), pairs,
                                scale=1.0, causal=False)
    with pytest.raises(ValueError, match="head sizes"):
        flash._flash_fwd_kernel(q[..., :8], k[..., :8], v[..., :8], pairs,
                                scale=1.0, causal=False)
    with pytest.raises(ValueError, match="one card"):
        flash._flash_fwd_kernel(q, k, v, pairs, scale=1.0, causal=False)


# -- the ring against the JAX ring --------------------------------------------

def _ring_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) * 0.3 for _ in range(3)]


def _jax_ring(fn, *arrays):
    mesh = m4j.make_mesh(N, axis="sp")
    spec = P(None, "sp")
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                 out_specs=spec, check_vma=False))(*arrays)


def _port_ring(arrays, **kw):
    comm = mt.make_mesh(N, axis="sp", device="cpu")
    q, k, v = (ring_bench.shard(torch.from_numpy(x), N) for x in arrays)
    return ring_bench.unshard(ring_attention(q, k, v, comm=comm, **kw))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(causal):
    arrays = _ring_inputs()
    for jax_impl in ("xla", "pallas"):
        want = np.asarray(_jax_ring(
            lambda a, b, c: jax_ring_attention(a, b, c, axis="sp",
                                               causal=causal, impl=jax_impl),
            *arrays))
        for impl in ("xla", "pallas", "auto"):
            got = _port_ring(arrays, causal=causal, impl=impl)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4,
                                       atol=2e-5, err_msg=f"{impl} vs "
                                       f"JAX {jax_impl}")


def test_ring_gradient_matches_jax():
    arrays = _ring_inputs(1)

    def loss(a, b, c):
        out = _jax_ring(lambda x, y, z: jax_ring_attention(
            x, y, z, axis="sp", causal=True, impl="xla"), a, b, c)
        return (out * out).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*arrays)
    comm = mt.make_mesh(N, axis="sp", device="cpu")
    qkv = [ring_bench.shard(torch.from_numpy(x), N).requires_grad_()
           for x in arrays]
    out = ring_attention(*qkv, comm=comm, causal=True, impl="xla")
    (out * out).sum().backward()
    for x, w in zip(qkv, want):
        np.testing.assert_allclose(ring_bench.unshard(x.grad).numpy(),
                                   np.asarray(w), rtol=5e-3, atol=5e-4)


def test_flash_route_backward_raises():
    """The flash route's backward runs on the CPU (the plain versions of
    kernels 6 and 7) and gives the recurrence's gradient."""
    comm = mt.make_mesh(N, device="cpu")
    grads = {}
    for impl in ("pallas", "xla"):
        qkv = [ring_bench.shard(torch.from_numpy(x), N).requires_grad_()
               for x in _ring_inputs(2)]
        out = ring_attention(*qkv, comm=comm, causal=True, impl=impl)
        out.sum().backward()
        grads[impl] = [x.grad for x in qkv]
    for got, want in zip(grads["pallas"], grads["xla"]):
        torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-4)


def test_ring_arguments():
    comm = mt.make_mesh(N, device="cpu")
    q = torch.zeros(N, B, T // N, H, D)
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        ring_attention(q, q, q, comm=comm, impl="triton")
    with pytest.raises(ValueError, match="Python float scale"):
        ring_attention(q, q, q, comm=comm, impl="pallas",
                       scale=torch.tensor(0.25))
    with pytest.raises(ValueError, match="must be"):
        ring_attention(q[0], q[0], q[0], comm=comm)
    # a tensor scale takes the recurrence, which it differentiates
    scale = torch.tensor(0.25, requires_grad=True)
    ring_attention(q, q, q, comm=comm, scale=scale).sum().backward()
    assert scale.grad is not None


def test_ring_hops_and_launches():
    """n - 1 hops of k and v per forward, each one ring_shift_n call."""
    comm = mt.make_mesh(N, device="cpu")
    q = torch.zeros(N, B, T // N, H, D)
    calls = []
    orig = coll.ring_shift_n

    def counted(xs, c, shift=1):
        calls.append((len(xs), shift))
        return orig(xs, c, shift)

    coll.ring_shift_n = counted
    try:
        ring_attention(q, q, q, comm=comm, impl="pallas", causal=True)
    finally:
        coll.ring_shift_n = orig
    assert calls == [(2, 1)] * (N - 1)


def test_benchmark_runs_on_the_cpu():
    rec, out = ring_bench.run((1, 64, 2, 16), 4, 1, torch.float32,
                              device="cpu")
    assert out.shape == (4, 1, 16, 2, 16)
    assert rec["tflops"] is None and rec["device"] == "cpu"
    assert rec["max_abs_diff"] == 0.0
    assert rec["flash_launches_per_forward"] == 0.0


# -- the check that holds kernel 5 to its plain version ----------------------

def _in_two(q, k, v, cut, resume):
    """One causal block as two, keys ``[0, cut)`` and ``[resume, Tk)``,
    combined as the ring combines its steps: p rounded against each part's
    maximum, as kernel 5's running maximum rounds it; ``resume > cut``
    drops the keys between."""
    kw = dict(scale=1.0, causal=True)
    o1, m1, l1 = flash.flash_fwd_block_plain(q, k[:, :cut], v[:, :cut], 0,
                                             0, **kw)
    o2, m2, l2 = flash.flash_fwd_block_plain(q, k[:, resume:], v[:, resume:],
                                             0, resume, **kw)
    m = torch.maximum(m1, m2)
    a1, a2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return o1 * a1 + o2 * a2, m, l1 * a1 + l2 * a2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_check_passes_rounding_and_catches_a_dropped_tile(dtype):
    """The o error over the noise scale passes p rounded against another
    maximum and fails a block that lost one 64-key tile, in the rows past
    it only, even when l is right."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(4, 512, 64).astype(np.float32))
               .to(dtype) for _ in range(3))
    q = flash.prescale(q)
    ref = flash.flash_fwd_block_plain(q, k, v, 0, 0, scale=1.0, causal=True)
    noise = chk.noise(q, k, v, 0, 0, scale=1.0, causal=True)
    sound = chk.errors(_in_two(q, k, v, 256, 256), ref, noise)
    assert chk.within(sound, dtype) and sound["o"] > 0, sound
    o, m, l = _in_two(q, k, v, 448, 512)
    assert not chk.within(chk.errors((o, m, l), ref, noise), dtype)
    late = (o, m, ref[2])  # rows past key 448 only, l left right
    errs = chk.errors(late, ref, noise)
    assert errs["l"] == 0.0 and errs["o"] > 3 * chk.TOL[dtype]["o"], errs


def test_ring_noise_is_the_global_blocks_noise():
    comm = mt.make_mesh(N, device="cpu")
    q, k, v = (torch.from_numpy(x) for x in _ring_inputs(3))
    sharded = [ring_bench.shard(x, N) for x in (q, k, v)]
    noise = chk.ring_noise(*sharded, comm, True)
    got = ring_bench.unshard(noise)
    qf, kf, vf = (flash._to_bhtd(x) for x in (flash.prescale(q), k, v))
    want = flash._from_bhtd(chk.noise(qf, kf, vf, 0, 0, scale=1.0,
                                      causal=True), (B,), H)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    out, ref = chk.ring_outputs(*sharded, comm, True)
    assert torch.equal(out, ref)  # both plain on the CPU
    assert chk.scaled_error(out, ref, noise) == 0.0


# -- the k/v rotation ---------------------------------------------------------

SHIFTS = (1, -1, 2)


@pytest.fixture(scope="module")
def jax_shifts():
    """The inputs and ``pallas_collectives.ring_shift_n``'s results at each
    of ``SHIFTS``, in one compile."""
    rng = np.random.RandomState(13)
    x = rng.randn(N * 4, 8).astype(np.float32)
    y = rng.randint(-100, 100, (N * 4, 3)).astype(np.int32)
    mesh = jax.make_mesh((N,), ("x",))
    want = jax.jit(jax.shard_map(
        lambda a, b: tuple(pc.ring_shift_n((a, b), "x", s) for s in SHIFTS),
        mesh=mesh, in_specs=P("x"), out_specs=P("x")))(x, y)
    return x, y, dict(zip(SHIFTS, want))


@pytest.mark.parametrize("shift", SHIFTS)
def test_ring_shift_n_matches_jax(jax_shifts, shift):
    x, y, want = jax_shifts
    comm = mt.make_mesh(N, axis="x", device="cpu")
    got = coll.ring_shift_n((torch.from_numpy(x).reshape(N, 4, 8),
                             torch.from_numpy(y).reshape(N, 4, 3)), comm,
                            shift)
    for g, w in zip(got, want[shift]):
        np.testing.assert_array_equal(g.reshape(w.shape).numpy(),
                                      np.asarray(w))
    assert coll.ring_shift_n((got[0],), comm, 0)[0] is got[0]


def test_ring_shift_n_gradient_is_the_reverse_shift():
    comm = mt.make_mesh(N, device="cpu")
    x = torch.arange(N * 3, dtype=torch.float32).reshape(N, 3)
    x.requires_grad_()
    a, b = coll.ring_shift_n((x, 2 * x), comm, 1)
    w = torch.arange(N * 3, dtype=torch.float32).reshape(N, 3)
    (a * w + b * w).sum().backward()
    assert torch.equal(x.grad, 3 * coll.ring_shift(w, comm, -1))
