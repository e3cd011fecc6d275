"""The port's flash backward held against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
(the Pallas kernels in interpret mode; the ring on the 8-device CPU mesh of
``tests/conftest.py``) and through the port's on CPU tensors, where
kernels 6 and 7 and the hop run their plain versions.

Tolerances: one ring step against ``_flash_bwd_block`` as
``tests/parallel/test_flash.py`` holds the forward block (f32 rtol and atol
1e-5; bf16 inputs rtol and atol 2e-2); the ring's gradient as
``tests/parallel/test_attention.py:80`` holds the JAX ring's (rtol 5e-3,
atol 5e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpi4jax_tpu as m4j
from mpi4jax_tpu.ops.flash import _flash_bwd_block
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

# tests/test_torch_flash.py's BLOCK_CASES: (causal, q_off, k_off)
BLOCK_CASES = [
    (False, 0, 0),
    (True, 0, 0),       # diagonal block
    (True, 64, 0),      # k fully in the past
    (True, 16, 32),     # partial overlap, some rows see no key
]
SCALE = 0.25


def _block_inputs(seed, causal, q_off, k_off):
    """q, do (BH, TQ, D), k, v (BH, TK, D) and f32 lse, delta (BH, TQ, 1):
    lse the rows' logsumexp over the keys they see plus log(1 + u), the
    mass of other blocks (u where a row sees none), delta a normal draw."""
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(BH, TQ, D).astype(np.float32) * 0.4 for _ in "qd")
    k, v = (rng.randn(BH, TK, D).astype(np.float32) * 0.4 for _ in "kv")
    u = rng.rand(BH, TQ, 1).astype(np.float32) * 2
    s = np.einsum("bqd,bkd->bqk", q, k) * SCALE
    seen = np.ones((TQ, TK), bool)
    if causal:
        seen = ((k_off + np.arange(TK))[None]
                <= (q_off + np.arange(TQ))[:, None])
    s = np.where(seen, s, -np.inf)
    m = s.max(-1, keepdims=True)
    live = np.isfinite(m)
    with np.errstate(divide="ignore"):  # the rows that see no key
        lse = np.where(live, m + np.log(np.exp(s - np.where(live, m, 0)).sum(
            -1, keepdims=True)) + np.log1p(u), u).astype(np.float32)
    delta = (rng.randn(BH, TQ, 1) * 0.3).astype(np.float32)
    return q, k, v, do, lse, delta


@pytest.fixture(scope="module")
def jax_blocks():
    """``_flash_bwd_block``'s triples for ``BLOCK_CASES`` in f32: one
    compile per causal flag, the offsets traced as in the ring."""
    fns = {causal: jax.jit(
        lambda *a, causal=causal: _flash_bwd_block(
            *a, scale=SCALE, causal=causal, block_q=16, block_k=16,
            interpret=True))
        for causal in (False, True)}
    out = {}
    for case in BLOCK_CASES:
        causal, qo, ko = case
        arrays = _block_inputs(1, *case)
        out[case] = (arrays, fns[causal](*arrays, jnp.int32(qo),
                                         jnp.int32(ko)))
    return out


@pytest.mark.parametrize("causal,q_off,k_off", BLOCK_CASES)
def test_block_plain_matches_jax(jax_blocks, causal, q_off, k_off):
    arrays, want = jax_blocks[(causal, q_off, k_off)]
    got = flash.flash_bwd_block_plain(
        *map(torch.from_numpy, arrays), torch.tensor(q_off),
        torch.tensor(k_off), scale=SCALE, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if causal and q_off < k_off:
        # rows that see no key: dq exactly 0, as the skipped JAX tiles give
        dead = q_off + np.arange(TQ) < k_off
        assert not got[0][:, dead].any()


def test_block_plain_bf16_matches_jax():
    arrays = _block_inputs(2, True, 16, 0)
    q, k, v, do = (jnp.asarray(x).astype(jnp.bfloat16) for x in arrays[:4])
    lse, delta = map(jnp.asarray, arrays[4:])
    want = jax.jit(lambda *a: _flash_bwd_block(
        *a, jnp.int32(16), jnp.int32(0), scale=SCALE, causal=True,
        block_q=16, block_k=16, interpret=True))(q, k, v, do, lse, delta)
    tq, tk, tv, tdo = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                       .to(torch.bfloat16) for x in (q, k, v, do))
    got = flash.flash_bwd_block_plain(
        tq, tk, tv, tdo, torch.from_numpy(arrays[4]),
        torch.from_numpy(arrays[5]), 16, 0, scale=SCALE, causal=True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-2,
                                   atol=2e-2, err_msg=name)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    arrays = [torch.from_numpy(x) for x in _block_inputs(3, True, 16, 32)]
    offs = torch.tensor([0, 16, 40])
    got = flash.flash_bwd_block(*arrays, offs, 32, scale=SCALE, causal=True)
    ref = flash.flash_bwd_block_plain(*arrays, offs, 32, scale=SCALE,
                                      causal=True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    pairs = torch.zeros(BH, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="one card"):
        flash._flash_bwd_dq_kernel(*arrays, pairs, scale=1.0, causal=False)
    with pytest.raises(ValueError, match="one card"):
        flash._flash_bwd_dkv_kernel(*arrays, pairs, scale=1.0, causal=False)


# -- the ring's gradient against jax.grad of the JAX ring ---------------------

def _ring_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) * 0.3 for _ in range(4)]


@pytest.fixture(scope="module")
def jax_grads():
    """``jax.grad`` of ``sum(out * w)`` through the JAX ring on 4 ranks,
    causal, for both of its impls."""
    q, k, v, w = _ring_inputs(1)
    mesh = m4j.make_mesh(N, axis="sp")
    spec = P(None, "sp")
    out = {}
    for impl in ("pallas", "xla"):
        fn = jax.shard_map(
            lambda a, b, c, impl=impl: jax_ring_attention(
                a, b, c, axis="sp", causal=True, impl=impl),
            mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
        out[impl] = jax.jit(jax.grad(
            lambda a, b, c: (fn(a, b, c) * w).sum(),
            argnums=(0, 1, 2)))(q, k, v)
    return out


def test_flash_route_gradient_matches_jax(jax_grads):
    q, k, v, w = _ring_inputs(1)
    comm = mt.make_mesh(N, axis="sp", device="cpu")
    qkv = [ring_bench.shard(torch.from_numpy(x), N).requires_grad_()
           for x in (q, k, v)]
    out = ring_attention(*qkv, comm=comm, causal=True, impl="pallas")
    (out * ring_bench.shard(torch.from_numpy(w), N)).sum().backward()
    for impl, want in jax_grads.items():
        for name, x, g in zip("qkv", qkv, want):
            np.testing.assert_allclose(
                ring_bench.unshard(x.grad).numpy(), np.asarray(g),
                rtol=5e-3, atol=5e-4, err_msg=f"d{name} vs JAX {impl}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_backward_steps_and_hops(n, monkeypatch):
    """n block steps (one launch each of kernels 6 and 7 on the card), one
    ring_shift_n per step at n > 1, carrying k, v, dk and dv and at the
    last step dk and dv only; none at n = 1."""
    comm = mt.make_mesh(n, device="cpu")
    q = torch.randn(n, B, T // n, H, D, requires_grad=True)
    out = ring_attention(q, q, q, comm=comm, causal=True, impl="pallas")
    steps, hops = [], []
    plain, shift = flash.flash_bwd_block_plain, coll.ring_shift_n
    monkeypatch.setattr(flash, "flash_bwd_block_plain",
                        lambda *a, **kw: steps.append(1) or plain(*a, **kw))
    monkeypatch.setattr(coll, "ring_shift_n", lambda xs, c, s=1: hops.append(
        (len(xs), s)) or shift(xs, c, s))
    out.sum().backward()
    assert len(steps) == n
    assert hops == ([(4, 1)] * (n - 1) + [(2, 1)] if n > 1 else [])
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())


# -- the card checks' ring helpers, on the CPU --------------------------------

def _ring_args(n, seed=2):
    """Sharded f32 q, k, v and dO on an n-rank mesh, with its comm."""
    q, k, v, do = (ring_bench.shard(torch.from_numpy(x), n)
                   for x in _ring_inputs(seed))
    return q, k, v, do, mt.make_mesh(n, device="cpu")


def test_ring_bwd_steps_sum_to_the_ring_gradient():
    """Each step of ``ring_bwd_steps`` through the plain block, dk and dv
    taken home to the rank whose k/v block the step held, sums to the
    ring's own gradient."""
    q, k, v, do, comm = _ring_args(N)
    (dq, dk, dv), _ = chk.ring_grads(q, k, v, do, comm, True)
    sq = sk = sv = 0
    for i, st in enumerate(chk.ring_bwd_steps(q, k, v, do, comm, True)):
        gq, gk, gv = flash.flash_bwd_block_plain(
            *st.args[:6], st.offs[:, 0], st.offs[:, 1], scale=1.0,
            causal=True)
        sq = sq + gq
        # step i: rank c held the block of rank c - i
        home = [torch.roll(x.reshape(N, -1, T // N, D), -i, 0) for x in
                (gk, gv)]
        sk, sv = sk + home[0], sv + home[1]
    for got, want in ((sq, dq), (sk, dk), (sv, dv)):
        torch.testing.assert_close(
            flash._from_bhtd(got.reshape(-1, T // N, D), (N, B), H), want,
            rtol=1e-5, atol=1e-7)


def test_ring_bwd_noise_does_not_depend_on_the_ring():
    """The noise scales of the gradients over every pair of the global
    sequence, summed along a 4-rank ring, are those of one rank's block."""
    q, k, v, do, comm = _ring_args(N)
    got = chk.ring_bwd_noise(q, k, v, do, comm, True)
    one = chk.ring_bwd_noise(*(ring_bench.unshard(x)[None] for x in
                               (q, k, v, do)), mt.make_mesh(1, device="cpu"),
                             True)
    for g, w in zip(got, one):
        assert bool((w > 0).any())
        torch.testing.assert_close(ring_bench.unshard(g), w[0], rtol=1e-4,
                                   atol=1e-7)


def test_run_backward_checks_its_gradients():
    """Path (e)'s record holds the timed step's gradients to the plain
    route's (both the plain recurrence on the CPU: errors 0) and to the
    f32 gradients cast, bit for bit."""
    rec, grads = ring_bench.run_backward((B, T, H, D), N, 1, torch.float32,
                                         device="cpu", seed=4)
    assert rec["within"] and rec["grads_are_f32_cast"], rec
    assert all(rec["grad_errors"][x] == 0.0 for x in ("dq", "dk", "dv"))
    assert all(g.shape == (N, B, T // N, H, D) for g in grads)
    q, k, v = (ring_bench.shard(x, N) for x in ring_bench.make_qkv(
        (B, T, H, D), torch.float32, "cpu", 4))
    do = ring_bench.shard(ring_bench.make_qkv((B, T, H, D), torch.float32,
                                              "cpu", 5)[0], N)
    comm = mt.make_mesh(N, device="cpu")
    bad = (grads[0] * 2, grads[1], grads[2])
    assert not chk.ring_grad_check(q, k, v, do, comm, True,
                                   bad)["grads_are_f32_cast"]


def test_use_plain_reaches_the_backward_thread():
    """``use_plain()`` holds in every thread: autograd runs a CUDA tensor's
    backward on its own device thread, which must take the plain versions
    when the forward did."""
    import threading

    seen = []
    with coll.use_plain():
        t = threading.Thread(target=lambda: seen.append(coll._route.plain))
        t.start()
        t.join(10)
    assert not t.is_alive() and seen == [True]
    assert not coll._route.plain
