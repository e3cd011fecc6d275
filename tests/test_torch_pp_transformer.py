"""The port's pipeline-parallel GPT held against the JAX package's, on the
CPU.

The same configuration (``tests/models/test_pp_transformer.py``'s ``CFG``,
3 microbatches of B2 T16), the same initial parameters and the same tokens,
made with numpy from a seed, go through the JAX package's ``PPGPT`` train
step (on the CPU mesh of ``tests/conftest.py``) and the port's
``PPGPT.train_step`` on CPU tensors, at pp = 1, 2 and 4.

Tolerances: the initial parameters bit for bit (the same numpy draws);
the loss within rtol 2e-5 (``test_pp_transformer.py``'s, against its dense
reference) and every parameter after one SGD step at lr 0.1 within atol
1e-6 in f32 (the packages sum in other orders; read: the
losses within 7e-8 relative, the parameters within 2e-8).  The loss also
matches the dense, unpipelined forward of the port's own blocks, and at
every pp the port gives the pp = 1 loss.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mpi4jax_tpu.models import pp_transformer as jpp
from mpi4jax_tpu.models.transformer import GPTConfig as JConfig

from mpi4jax_tpu_torch.examples import train_gpt
from mpi4jax_tpu_torch.models import pp_transformer as ppm
from mpi4jax_tpu_torch.models.transformer import _layernorm

CFG = dict(vocab=32, d_model=16, n_heads=4, n_layers=4, d_ff=32, max_seq=16)
M, BMB, T = 3, 2, 16
LR = 0.1
PPS = [1, 2, 4]


def tokens():
    rng = np.random.RandomState(0)
    return rng.randint(0, CFG["vocab"], (M, BMB, T)).astype(np.int32)


@pytest.mark.parametrize("pp", PPS)
def test_init_params_match_jax_bit_for_bit(pp):
    want = jpp.init_params(JConfig(**CFG), pp=pp, seed=3)
    got = ppm.init_params(ppm.GPTConfig(**CFG), pp=pp, seed=3)
    assert ppm.PPGPTParams._fields == jpp.PPGPTParams._fields
    for f in ppm.PPGPTParams._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    with pytest.raises(ValueError):
        ppm.init_params(ppm.GPTConfig(**CFG), pp=3)


def _jax_step(pp):
    mesh = Mesh(np.array(jax.devices()[:pp]).reshape(pp), ("pp",))
    model = jpp.PPGPT(JConfig(**CFG), mesh)
    params = jpp.init_params(JConfig(**CFG), pp=pp, seed=0)
    loss, params = model.train_step_fn(lr=LR)(params, jnp.asarray(tokens()))
    return float(loss), params


@pytest.mark.parametrize("pp", PPS)
def test_one_step_matches_jax(pp):
    want_loss, want = _jax_step(pp)
    # the port carries the JAX parameters over
    model = ppm.PPGPT(ppm.GPTConfig(**CFG), pp,
                      jpp.init_params(JConfig(**CFG), pp=pp, seed=0),
                      device="cpu")
    loss = float(model.train_step(torch.from_numpy(tokens()), lr=LR))
    np.testing.assert_allclose(loss, want_loss, rtol=2e-5)
    got = model.global_params()
    for f in ppm.PPGPTParams._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    # every replica of a replicated field took the same update
    for f in ppm.REPLICATED:
        p = getattr(model.params, f).detach()
        assert torch.equal(p, p[:1].expand_as(p)), f


def _dense_loss(params, toks):
    """The unpipelined forward of the same weights (the JAX test's
    ``dense_loss``), with the port's own block ops."""
    cfg = ppm.GPTConfig(**CFG)
    p = ppm.params_from_numpy(params, "cpu")
    t = torch.from_numpy(toks).reshape(M * BMB, T).long()
    x = (p.wte[t] + p.wpe[:T][None])[None]
    pp = p.w_qkv.shape[0]
    model = ppm.PPGPT(cfg, 1, device="cpu")
    for s in range(pp):
        stage = tuple(getattr(p, f)[s][None] for f in ppm.STAGE)
        x = model._stage(stage, x)
    x = _layernorm(x.reshape(1, -1, cfg.d_model), p.lnf[None])
    logp = torch.log_softmax(torch.matmul(x, p.wte.T), -1)[0]
    tgt = torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], 1).reshape(-1)
    mask = torch.cat([torch.ones(M * BMB, T - 1), torch.zeros(M * BMB, 1)],
                     1).reshape(-1)
    nll = -logp[torch.arange(tgt.numel()), tgt]
    return float((nll * mask).sum() / mask.sum())


@pytest.mark.parametrize("pp", [2, 4])
def test_loss_matches_dense_and_pp1(pp):
    params = ppm.init_params(ppm.GPTConfig(**CFG), pp=pp, seed=1)
    model = ppm.PPGPT(ppm.GPTConfig(**CFG), pp, params, device="cpu")
    loss = float(model.train_step(torch.from_numpy(tokens()), lr=0.0))
    np.testing.assert_allclose(loss, _dense_loss(params, tokens()),
                               rtol=2e-5)
    one = ppm.PPGPT(ppm.GPTConfig(**CFG), 1, ppm.init_params(
        ppm.GPTConfig(**CFG), pp=1, seed=1), device="cpu")
    np.testing.assert_allclose(
        float(one.train_step(torch.from_numpy(tokens()), lr=0.0)), loss,
        rtol=2e-5)


def test_training_reduces_loss():
    model = ppm.PPGPT(ppm.GPTConfig(**CFG), 4, device="cpu")
    toks = torch.from_numpy(tokens())
    losses = [float(model.train_step(toks, lr=LR)) for _ in range(6)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_pp_cli_on_the_cpu(capsys):
    rc = train_gpt.main(["--device", "cpu", "--pp", "4", "--steps", "2",
                         "--seq", "16", "--batch", "2", "--d-model", "16",
                         "--heads", "4", "--layers", "2", "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["pp"] == 4 and rec["device"] == "cpu"
    assert len(rec["losses"]) == 3 and np.all(np.isfinite(rec["losses"]))
