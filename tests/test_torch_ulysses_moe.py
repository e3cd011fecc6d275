"""The port's Ulysses attention and MoE layer held against the JAX
package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX layers
(inside ``shard_map`` on the CPU mesh of ``tests/conftest.py``) and the
port's on CPU tensors with the ranks leading, where the alltoall runs its
plain version.

Tolerances: ``seq_to_heads`` and ``heads_to_seq`` move values only and
must agree bit for bit; ``ulysses_attention``, causal and not, within the
JAX test's rtol 2e-4 and atol 2e-5 of JAX's and of a dense reference;
``router_top1``'s expert indices, and ``dispatch``'s queue positions and
keep masks, exactly (a capacity factor of 0.5 drops tokens); the gate
probabilities and the dispatched rows within rtol 1e-6; ``moe_ffn``'s
output within rtol 1e-5 and atol 1e-6 (the expert products sum in other
orders; dropped tokens are exactly zero in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpi4jax_tpu as m4j
from mpi4jax_tpu.parallel import moe as jmoe
from mpi4jax_tpu.parallel import ulysses as jul

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch import parallel
from mpi4jax_tpu_torch.parallel import moe, ulysses

N = 8
B, T, H, D = 2, 64, 8, 16


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    return tuple((rng.randn(B, T, H, D) * 0.3).astype(np.float32)
                 for _ in range(3))


def _shard(x, n=N):
    """Global ``(B, T, ...)`` to the port's ``(n, B, T / n, ...)``."""
    t = torch.from_numpy(x)
    return t.reshape(t.shape[0], n, -1, *t.shape[2:]).movedim(1, 0)


def _unshard(x):
    return x.movedim(0, 1).reshape(x.shape[1], -1, *x.shape[3:])


def _jax_sharded(fn, *args):
    mesh = m4j.make_mesh(N, axis="sp")
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(None, "sp"),
                                 out_specs=P("sp"), check_vma=False))(*args)


def test_seq_heads_transposes_bit_for_bit(qkv):
    q = qkv[0]

    def both(x):
        h = jul.seq_to_heads(x, axis="sp")
        return jnp.stack([h, h])[None], jul.heads_to_seq(h, axis="sp")[None]

    heads, back = _jax_sharded(both, q)
    comm = mt.make_mesh(N, axis="sp", device="cpu")
    got = ulysses.seq_to_heads(_shard(q), comm=comm)
    assert got.shape == (N, B, T, H // N, D)
    assert np.array_equal(got.numpy(), np.asarray(heads)[:, 0])
    again = ulysses.heads_to_seq(got, comm=comm)
    assert np.array_equal(again.numpy(), np.asarray(back))
    assert torch.equal(again, _shard(q))
    with pytest.raises(ValueError, match="heads"):
        ulysses.seq_to_heads(torch.zeros(N, 1, 2, 4, 3), comm=comm)
    with pytest.raises(ValueError, match="sequence"):
        ulysses.heads_to_seq(torch.zeros(N, 1, 4, 1, 3), comm=comm)


def dense_attention(q, k, v, causal):
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
    if causal:
        scores = np.where(np.tril(np.ones((T, T), bool))[None, None],
                          scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_matches_jax(qkv, causal):
    q, k, v = qkv
    want = np.asarray(_jax_sharded(
        lambda a, b_, c: jul.ulysses_attention(a, b_, c, axis="sp",
                                               causal=causal)[None],
        q, k, v))
    comm = mt.make_mesh(N, axis="sp", device="cpu")
    got = ulysses.ulysses_attention(*(_shard(x) for x in qkv), comm=comm,
                                    causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_unshard(got).numpy(),
                               dense_attention(q, k, v, causal), rtol=2e-4,
                               atol=2e-5)


def test_ulysses_gradient_flows_through_the_alltoalls(qkv):
    comm = mt.make_mesh(4, axis="sp", device="cpu")
    q, k, v = (_shard(x, 4).clone().requires_grad_() for x in qkv)
    out = ulysses.ulysses_attention(q, k, v, comm=comm, causal=True)
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    qd, kd, vd = (torch.from_numpy(x).double().requires_grad_()
                  for x in qkv)
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) / D ** 0.5
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool).tril(), -1e300)
    ref = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vd)
    want = torch.autograd.grad(ref.square().sum(), (qd, kd, vd))
    for g, w in zip((gq, gk, gv), want):
        np.testing.assert_allclose(_unshard(g).numpy(), w.numpy(),
                                   rtol=2e-4, atol=2e-5)


NM, TOK, DM, FF = 4, 24, 8, 16


@pytest.fixture(scope="module")
def moe_case():
    """Per-rank tokens, the JAX per-rank parameters, and JAX's router,
    dispatch and ``moe_ffn`` results at a capacity factor that drops
    tokens."""
    rng = np.random.RandomState(7)
    x = rng.randn(NM, TOK, DM).astype(np.float32)
    key = jax.random.PRNGKey(3)
    per_rank = [jax.tree.map(np.asarray, jmoe.init_moe_params(
        key, DM, FF, NM, r)) for r in range(NM)]
    stacked = {k: np.stack([p[k] for p in per_rank]) for k in per_rank[0]}
    cap = jmoe.expert_capacity(TOK, NM, 0.5)
    mesh = m4j.make_mesh(NM)

    def per(xr, pr):
        xr = xr[0]
        pr = {k: v[0] for k, v in pr.items()}
        idx, prob, _ = jmoe.router_top1(xr, pr["w_gate"])
        recv, (i2, pos, keep) = jmoe.dispatch(xr, idx, cap)
        y = jmoe.moe_ffn(xr, pr, capacity_factor=0.5)
        return tuple(a[None] for a in (idx, prob, recv, pos, keep, y))

    out = jax.jit(m4j.spmd(per, mesh=mesh))(x, stacked)
    return x, per_rank, cap, [np.asarray(a) for a in out]


def test_moe_matches_jax_with_dropped_tokens(moe_case):
    x, per_rank, cap, (idx, prob, recv, pos, keep, y) = moe_case
    assert not keep.all()  # tokens were dropped
    comm = mt.make_mesh(NM, device="cpu")
    params = moe.params_from_numpy(per_rank, "cpu")
    xt = torch.from_numpy(x)
    got_idx, got_prob, _ = moe.router_top1(xt, params["w_gate"])
    assert np.array_equal(got_idx.numpy(), idx)
    np.testing.assert_allclose(got_prob.numpy(), prob, rtol=1e-6)
    got_recv, (_, got_pos, got_keep) = moe.dispatch(xt, got_idx, cap,
                                                    comm=comm)
    assert np.array_equal(got_keep.reshape(keep.shape).numpy(), keep)
    assert np.array_equal(got_pos.reshape(pos.shape).numpy(), pos)
    np.testing.assert_allclose(got_recv.numpy(), recv, rtol=1e-6)
    got = moe.moe_ffn(xt, params, comm=comm, capacity_factor=0.5)
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-5, atol=1e-6)
    assert not got.numpy()[~keep].any()  # dropped tokens come back as zeros


def test_moe_controls_raise_on_a_mesh_comm_and_attribute():
    comm = mt.make_mesh(NM, device="cpu")
    params = moe.params_from_numpy(moe.init_moe_params(DM, FF, NM, 0),
                                   "cpu")
    x = torch.zeros(NM, TOK, DM)
    with pytest.raises(NotImplementedError, match="compression"):
        moe.moe_ffn(x, params, comm=comm, compression="int8")
    with pytest.raises(NotImplementedError, match="algo"):
        moe.moe_ffn(x, params, comm=comm, algo="qalltoall")
    assert parallel.moe is moe
    assert moe.expert_capacity(8192, 4) == 2560
    assert moe.expert_capacity(1, 8) == 1
