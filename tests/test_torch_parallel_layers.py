"""The port's tp, pipeline and dp layers held against the JAX package's, on
the CPU.

The same inputs, made with numpy from a seed, go through the JAX layers
(``tests/parallel/test_strategies.py``'s cases, inside ``spmd`` on the
8-device CPU mesh of ``tests/conftest.py``) and the port's on CPU tensors
with the ranks leading.

Tolerances: the pipeline within rtol 1e-6 of a torch sequential
composition and of JAX's (each tick's batched product sums in another
order than the sequential one and than XLA's), its non-last stages exactly
zero, its gradient within rtol 1e-5 and atol 1e-6 of the sequential one's;
tp's pair and its transpose, and the dp gradient, at JAX's own test
tolerances (rtol 1e-4, atol 1e-4; rtol 1e-5); ``sync_gradients`` within
rtol 1e-6 of the mean's magnitude (the port's butterfly or ring and XLA's
``psum`` add the ranks in other orders), with the same leaf order, the same
number of allreduces and the same sizes per allreduce as the JAX package
traces, per-leaf and bucketed, for every ``MPI4JAX_TPU_PLAN_BUCKET_KB``
case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpi4jax_tpu as m4j
from mpi4jax_tpu.models import resnet as jresnet
from mpi4jax_tpu.parallel import dp as jdp
from mpi4jax_tpu.parallel import tp as jtp
from mpi4jax_tpu.parallel.pipeline import pipeline_apply as jpipeline

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.models import resnet
from mpi4jax_tpu_torch.parallel import dp, tp
from mpi4jax_tpu_torch.parallel.pipeline import pipeline_apply
from mpi4jax_tpu_torch.utils import config
from mpi4jax_tpu_torch.utils import tree

N = 8


@pytest.fixture(scope="module")
def mesh():
    return m4j.make_mesh(N)


# -- tp ------------------------------------------------------------------


def test_tp_column_row_pair(mesh):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 16).astype(np.float32)
    w1 = rng.randn(16, 32).astype(np.float32)
    w2 = rng.randn(32, 8).astype(np.float32)
    dense = np.maximum(x @ w1, 0) @ w2

    def per_rank(x_rep):
        r = jax.lax.axis_index("mpi")
        w1_shard = jax.lax.dynamic_slice(w1, (0, r * 4), (16, 4))
        w2_shard = jax.lax.dynamic_slice(w2, (r * 4, 0), (4, 8))
        h = jnp.maximum(jtp.column_parallel(x_rep, w1_shard), 0)
        return jtp.row_parallel(h, w2_shard)[None]

    want = np.asarray(jax.jit(m4j.spmd(per_rank, mesh=mesh, in_specs=P(),
                                       out_specs=P("mpi")))(x))
    comm = mt.make_mesh(N, device="cpu")
    w1s = torch.stack([torch.from_numpy(tp.shard_columns(w1, r, N))
                       for r in range(N)])
    w2s = torch.stack([torch.from_numpy(tp.shard_rows(w2, r, N))
                       for r in range(N)])
    xs = torch.from_numpy(x).expand(N, 3, 16)
    h = torch.relu(tp.column_parallel(xs, w1s))
    got = tp.row_parallel(h, w2s, comm=comm).numpy()
    for r in range(N):
        np.testing.assert_allclose(got[r], dense, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[r], want[r], rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tp.shard_columns(w1, 0, 5)
    with pytest.raises(ValueError):
        tp.shard_rows(w2, 0, 5)


def test_tp_transpose_matvec():
    """The distributed matvec and its transpose (autograd's, as
    ``jax.linear_transpose`` of the JAX test): A column-split, x sharded."""
    rng = np.random.RandomState(2)
    a = rng.randn(6, N * 2).astype(np.float32)
    x = rng.randn(N * 2).astype(np.float32)
    comm = mt.make_mesh(N, device="cpu")
    a_shards = torch.from_numpy(a).reshape(6, N, 2).permute(1, 0, 2)
    xs = torch.from_numpy(x).reshape(N, 2).requires_grad_()
    y = mt.allreduce(torch.matmul(a_shards, xs[..., None])[..., 0],
                     op=mt.SUM, comm=comm)
    np.testing.assert_allclose(y[0].detach().numpy(), a @ x, rtol=1e-4,
                               atol=1e-4)
    ct = rng.randn(6).astype(np.float32)
    (xt,) = torch.autograd.grad(y[0], xs, torch.from_numpy(ct))
    np.testing.assert_allclose(xt.reshape(-1).numpy(), a.T @ ct, rtol=1e-4,
                               atol=1e-4)


# -- pipeline --------------------------------------------------------------


def test_pipeline_matches_sequential_and_jax(mesh):
    rng = np.random.RandomState(3)
    d, m = 8, 5
    ws = rng.randn(N, d, d).astype(np.float32) * 0.4
    xs = rng.randn(m, 2, d).astype(np.float32)

    def per_rank(w_all, mb):
        r = jax.lax.axis_index("mpi")
        w_mine = jax.lax.dynamic_index_in_dim(w_all, r, 0, keepdims=False)
        return jpipeline(lambda w, x: jnp.maximum(x @ w, 0), w_mine, mb,
                         axis="mpi")[None]

    want = np.asarray(jax.jit(m4j.spmd(per_rank, mesh=mesh,
                                       in_specs=(P(), P()),
                                       out_specs=P("mpi")))(ws, xs))

    comm = mt.make_mesh(N, device="cpu")
    mbs = torch.from_numpy(xs).expand(N, *xs.shape)
    out = pipeline_apply(lambda w, x: torch.relu(torch.matmul(x, w)),
                         torch.from_numpy(ws), mbs, comm=comm)
    seq = torch.from_numpy(xs)
    for s in range(N):
        seq = torch.relu(torch.matmul(seq, torch.from_numpy(ws[s])))
    assert out.shape == (N, m, 2, d)
    torch.testing.assert_close(out[N - 1], seq, rtol=1e-6, atol=1e-6)
    assert not out[:N - 1].any()  # the other stages masked to zero
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)


def test_pipeline_prepare_fn_and_gradient():
    """``prepare_fn`` feeds stage 0 only, and the gradient reaches every
    stage's weight through the reverse hops (4 stages, 3 microbatches)."""
    n, m, d = 4, 3, 5
    rng = np.random.RandomState(4)
    ws = torch.from_numpy(rng.randn(n, d, d).astype(np.float32) * 0.5)
    ws.requires_grad_()
    raw = torch.from_numpy(rng.randn(m, 2, d).astype(np.float32))
    comm = mt.make_mesh(n, device="cpu")
    out = pipeline_apply(lambda w, x: torch.tanh(torch.matmul(x, w)), ws,
                         raw.expand(n, *raw.shape), comm=comm,
                         prepare_fn=lambda mb: 2 * mb)
    seq = 2 * raw
    for s in range(n):
        seq = torch.tanh(torch.matmul(seq, ws[s]))
    torch.testing.assert_close(out[n - 1], seq, rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(out.sum(), ws)
    (want,) = torch.autograd.grad(seq.sum(), ws)
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)


# -- dp ------------------------------------------------------------------


def test_dp_value_and_synced_grad_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(4).astype(np.float32)
    xs = rng.randn(N * 2, 4).astype(np.float32)
    ys = rng.randn(N * 2).astype(np.float32)
    g_full = jax.grad(lambda w_: jnp.mean(jnp.stack([
        jnp.mean((xs[i * 2:(i + 1) * 2] @ w_ - ys[i * 2:(i + 1) * 2]) ** 2)
        for i in range(N)])))(w)

    comm = mt.make_mesh(N, device="cpu")
    params = {"w": torch.from_numpy(w).expand(N, 4).clone().requires_grad_()}

    def local_loss(p, x, y):
        return ((torch.matmul(x, p["w"][:, :, None])[..., 0] - y) ** 2
                ).mean(-1)

    loss, g = dp.value_and_synced_grad(local_loss, comm=comm)(
        params, torch.from_numpy(xs).reshape(N, 2, 4),
        torch.from_numpy(ys).reshape(N, 2))
    for r in range(N):
        np.testing.assert_allclose(g["w"][r].numpy(), np.asarray(g_full),
                                   rtol=1e-5)
    assert loss.shape == (N,)
    assert torch.equal(loss, loss[:1].expand(N))


NG = 4  # ranks of the sync tests
SYNC_CFG = dict(stages=(2, 1), widths=(8, 16), n_classes=5, groups=4,
                block="bottleneck", stem="imagenet")


def _grad_tree():
    """A ResNet-shaped gradient tree (``None`` projections included): per
    leaf ``(NG, *shape)`` f32 normals, the JAX tree and the port's."""
    params = jresnet.init_params(jresnet.ResNetConfig(**SYNC_CFG))
    rng = np.random.RandomState(5)
    jtree = jax.tree.map(
        lambda a: rng.randn(NG, *a.shape).astype(np.float32), params)
    ptree = tree.tree_map(torch.from_numpy, jtree)
    return jtree, ptree


def test_leaf_order_is_jax():
    jtree, ptree = _grad_tree()
    want = jax.tree.leaves(jtree)
    got = tree.leaves(ptree)
    assert len(got) == len(want) and len(got) > 20
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    blk = ptree["stages"][0][1]
    assert blk["proj"] is None and "conv3" in blk
    back = tree.unflatten(tree.flatten(ptree)[1], got)
    assert back["stages"][0][1]["proj"] is None
    assert isinstance(back["stem_gn"], tuple)


BUCKET_ENV = [(None, 0), ("", 1 << 20), ("  ", 1 << 20), ("0", 0),
              ("64", 64 * 1024), ("-3", 0)]


@pytest.mark.parametrize("raw,want", BUCKET_ENV,
                         ids=[repr(r) for r, _ in BUCKET_ENV])
def test_bucket_knob_as_jax(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("MPI4JAX_TPU_PLAN_BUCKET_KB", raising=False)
    else:
        monkeypatch.setenv("MPI4JAX_TPU_PLAN_BUCKET_KB", raw)
    assert dp._resolve_bucket_bytes(None) == want
    assert jdp._resolve_bucket_bytes(None) == want
    assert dp._resolve_bucket_bytes(128) == jdp._resolve_bucket_bytes(128)


def test_bucket_knob_malformed_raises_as_jax(monkeypatch):
    monkeypatch.setenv("MPI4JAX_TPU_PLAN_BUCKET_KB", "lots")
    for fn in (config.plan_bucket_bytes, lambda: dp._resolve_bucket_bytes(
            None)):
        with pytest.raises(ValueError, match="MPI4JAX_TPU_PLAN_BUCKET_KB"):
            fn()
    with pytest.raises(ValueError, match="MPI4JAX_TPU_PLAN_BUCKET_KB"):
        jdp._resolve_bucket_bytes(None)


def _jax_sync(jtree, bucket_bytes):
    """JAX's synced tree, and the per-rank element counts of its psums in
    trace order."""
    mesh = m4j.make_mesh(NG)
    fn = m4j.spmd(lambda g: jdp.sync_gradients(g, bucket_bytes=bucket_bytes),
                  mesh=mesh)
    jaxpr = jax.make_jaxpr(fn)(jtree)
    sizes = []

    def walk(jx):
        for eq in jx.eqns:
            if eq.primitive.name == "psum":
                sizes.extend(int(np.prod(v.aval.shape)) for v in eq.invars)
            for v in eq.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr)

    walk(jaxpr.jaxpr)
    return jax.jit(fn)(jtree), sizes


@pytest.mark.parametrize("bucket_bytes", [0, 2048, 64 * 1024])
def test_sync_gradients_matches_jax(monkeypatch, bucket_bytes):
    jtree, ptree = _grad_tree()
    want, jax_sizes = _jax_sync(jtree, bucket_bytes)
    comm = mt.make_mesh(NG, device="cpu")
    sizes = []
    allreduce = dp.allreduce

    def counting(x, *a, **k):
        sizes.append(x.numel() // NG)
        return allreduce(x, *a, **k)

    monkeypatch.setattr(dp, "allreduce", counting)
    got = dp.sync_gradients(ptree, comm=comm, bucket_bytes=bucket_bytes)
    assert sizes == jax_sizes
    if bucket_bytes:
        assert len(sizes) < len(tree.leaves(ptree))
    assert got["stages"][0][1]["proj"] is None
    for g, w, x in zip(tree.leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(jtree)):
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = np.abs(x).mean(0).max()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6 * scale)


def test_sync_gradients_reads_the_knob(monkeypatch):
    """Unset: one allreduce per leaf; set: the bucketed schedule."""
    _, ptree = _grad_tree()
    comm = mt.make_mesh(NG, device="cpu")
    calls = []
    allreduce = dp.allreduce
    monkeypatch.setattr(dp, "allreduce",
                        lambda x, *a, **k: calls.append(1) or allreduce(
                            x, *a, **k))
    monkeypatch.delenv("MPI4JAX_TPU_PLAN_BUCKET_KB", raising=False)
    dp.sync_gradients(ptree, comm=comm)
    per_leaf = len(calls)
    assert per_leaf == len(tree.leaves(ptree))
    calls.clear()
    monkeypatch.setenv("MPI4JAX_TPU_PLAN_BUCKET_KB", "")
    dp.sync_gradients(ptree, comm=comm)
    assert len(calls) < per_leaf


def test_pmean_of_integers_is_float():
    comm = mt.make_mesh(NG, device="cpu")
    x = torch.arange(NG, dtype=torch.int32).reshape(NG, 1)
    got = dp.pmean(x, comm=comm)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.full((NG, 1), 1.5))


def test_resnet_tree_carries_over():
    """``params_from_numpy`` keeps the JAX tree's structure and ``None``."""
    params = jresnet.init_params(jresnet.ResNetConfig(**SYNC_CFG), seed=2)
    got = resnet.params_from_numpy(
        jax.tree.map(np.asarray, params),
        ranks=3, device="cpu")
    assert got["stages"][0][1]["proj"] is None
    for a, b in zip(tree.leaves(got), jax.tree.leaves(params)):
        assert a.shape == (3, *b.shape) and a.requires_grad
        assert np.array_equal(a[2].detach().numpy(), np.asarray(b))
