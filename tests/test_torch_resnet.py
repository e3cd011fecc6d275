"""The port's data-parallel ResNet held against the JAX package's, on the
CPU.

The same configurations, initial parameters (numpy draws from a seed) and
seeded images go through the JAX package's ``forward`` and
``make_dp_train_step`` (on the CPU mesh of ``tests/conftest.py``) and the
port's on CPU tensors.

The forward cases cover the basic and bottleneck blocks, the small and
imagenet stems, f32 and bf16, and odd and even image sizes: XLA's
``"SAME"`` padding is asymmetric at stride 2 on even sizes (the imagenet
stem's 7x7/2 convolution and 3x3/2 pool, the bottleneck's strided 3x3),
which a symmetric ``padding=k // 2`` gets wrong.

Tolerances: the initial parameters bit for bit (the same numpy draws);
the f32 logits within 1e-5 of their largest magnitude (read: 3.2e-7),
the bf16 logits within 2e-2 of it (both round every convolution's output
to bf16, in other orders; read: 4.8e-3); one DP step at n = 2, the
loss within rtol 1e-5 and every parameter within atol 1e-6 (read: 1.5e-8).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as m4j
from mpi4jax_tpu.models import resnet as jr

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.examples import train_resnet
from mpi4jax_tpu_torch.models import resnet
from mpi4jax_tpu_torch.utils import tree

SMALL = dict(stages=(1, 1), widths=(8, 16), n_classes=5, groups=4)
# (block, stem, dtype, image size)
FORWARD_CASES = [
    ("basic", "small", "float32", 9),
    ("basic", "imagenet", "float32", 32),
    ("basic", "imagenet", "bfloat16", 16),
    ("bottleneck", "small", "bfloat16", 8),
    ("bottleneck", "imagenet", "float32", 30),
    ("bottleneck", "imagenet", "bfloat16", 33),
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
@pytest.mark.parametrize("stem", ["small", "imagenet"])
def test_init_params_match_jax_bit_for_bit(block, stem):
    kw = dict(SMALL, stages=(2, 1), block=block, stem=stem)
    want = jr.init_params(jr.ResNetConfig(**kw), seed=3)
    got = resnet.init_params(resnet.ResNetConfig(**kw), seed=3)
    assert got["stages"][0][1]["proj"] is None
    w, g = jax.tree.leaves(want), tree.leaves(got)
    assert len(w) == len(g)
    for a, b in zip(w, g):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a))
    full = resnet.resnet50_config()
    assert full == resnet.ResNetConfig(**jr.resnet50_config()._asdict())


def test_resnet50_counts():
    """153 leaves and 25.55 M parameters: what the DP step syncs."""
    params = resnet.init_params(resnet.resnet50_config(dtype="bfloat16"))
    leaves = tree.leaves(params)
    assert len(leaves) == 153
    assert sum(x.size for x in leaves) == 25_549_352


def test_same_padding_is_asymmetric_at_stride_2():
    assert resnet._same_pads(224, 7, 2) == (2, 3)
    assert resnet._same_pads(112, 3, 2) == (0, 1)
    assert resnet._same_pads(33, 3, 2) == (1, 1)
    assert resnet._same_pads(56, 1, 2) == (0, 0)
    assert resnet._same_pads(9, 3, 1) == (1, 1)


@pytest.mark.parametrize("block,stem,dtype,hw", FORWARD_CASES,
                         ids=["-".join(map(str, c)) for c in FORWARD_CASES])
def test_forward_matches_jax(block, stem, dtype, hw):
    kw = dict(SMALL, block=block, stem=stem, dtype=dtype)
    jcfg = jr.ResNetConfig(**kw)
    params = jr.init_params(jcfg, seed=1)
    # the head scaled so the logits are O(1), as the JAX bf16 test does
    params = dict(params, head=params["head"] * 100.0)
    x = np.random.RandomState(2).randn(3, hw, hw, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jr.forward(p, v, jcfg))(
        params, jnp.asarray(x)))
    scale = np.abs(want).max()
    assert scale > 0.1
    cfg = resnet.ResNetConfig(**kw)
    p = resnet.params_from_numpy(jax.tree.map(np.asarray, params), 1, "cpu")
    got = resnet.forward(p, torch.from_numpy(x)[None], cfg)
    assert got.dtype == torch.float32 and got.shape == (1, 3, 5)
    np.testing.assert_allclose(got[0].detach().numpy(), want, rtol=0,
                               atol=TOL[dtype] * scale)


def test_folds_agree_over_ranks():
    """Four ranks with their own weights, folded into the channels of one
    grouped convolution: each rank gets what the rank alone gives."""
    cfg = resnet.ResNetConfig(**SMALL, block="bottleneck", stem="imagenet")
    p = resnet.params_from_numpy(resnet.init_params(cfg, seed=4), 4, "cpu")
    with torch.no_grad():
        for leaf in tree.leaves(p):
            leaf.mul_(1 + 0.1 * torch.arange(4).reshape(4, *[1] * (
                leaf.dim() - 1)))
    x = torch.from_numpy(np.random.RandomState(5).randn(
        4, 2, 16, 16, 3).astype(np.float32))
    together = resnet.forward(p, x, cfg)
    for r in range(4):
        alone = resnet.forward(tree.tree_map(lambda a: a[r:r + 1], p),
                               x[r:r + 1], cfg)
        torch.testing.assert_close(together[r:r + 1], alone, rtol=1e-5,
                                   atol=1e-6)


def test_dp_step_matches_jax():
    kw = dict(SMALL, block="bottleneck", stem="imagenet", n_classes=4)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16, 16, 3).astype(np.float32)
    y = rng.randint(0, 4, (4,)).astype(np.int32)
    jcfg = jr.ResNetConfig(**kw)
    step = jr.make_dp_train_step(jcfg, m4j.make_mesh(2), lr=0.05)
    want_loss, want = step(jr.init_params(jcfg, 0), jnp.asarray(x),
                           jnp.asarray(y))
    cfg = resnet.ResNetConfig(**kw)
    comm = mt.make_mesh(2, device="cpu")
    params = resnet.params_from_numpy(resnet.init_params(cfg, 0), 2, "cpu")
    loss, params = resnet.make_dp_train_step(cfg, comm, lr=0.05)(
        params, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for a, b in zip(tree.leaves(params), jax.tree.leaves(want)):
        # every rank's replica took the synced update
        assert torch.equal(a[0], a[1])
        np.testing.assert_allclose(a[0].detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)


def test_resnet_cli_on_the_cpu(capsys):
    rc = train_resnet.main(["--device", "cpu", "--ranks", "2", "--steps",
                            "2", "--batch", "5", "--image", "16", "--depth",
                            "1", "1", "--widths", "8", "16", "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ranks"] == 2 and rec["batch"] == 4
    assert len(rec["losses"]) == 3 and np.all(np.isfinite(rec["losses"]))
    assert rec["losses"][-1] < rec["losses"][0]
