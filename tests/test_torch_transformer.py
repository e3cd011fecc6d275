"""The port's dp x tp x sp GPT held against the JAX package's, on the CPU.

The same configuration (``tests/models/test_transformer.py``'s ``CFG``, B4
T32), the same initial parameters and the same tokens, made with numpy
from a seed, go through the JAX package's train step (on the 8-device CPU
mesh of ``tests/conftest.py``) and the port's ``GPT.train_step`` on CPU
tensors, where ring attention takes its plain recurrence.

Tolerances: the initial parameters bit for bit (the same numpy draws);
the loss and every parameter after two steps in f32 within rtol 1e-4 and
atol 1e-6 (the two packages sum in other orders; AdamW's first steps move
a parameter by about lr = 3e-4 whatever the size of its gradient, so a
gradient that differs in its last bits moves the parameter alike; read:
the losses within 1.2e-7 relative, the parameters within 5.0e-7); the
first step's loss in bf16 within rtol 1e-3 (both round the projections'
operands to bf16, in other places; read: 5.6e-6).  The decomposed runs of
the port must give its own 1-device loss within ``test_transformer.py``'s
rtol 2e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from mpi4jax_tpu.models import transformer as jtf

from mpi4jax_tpu_torch.examples import train_gpt
from mpi4jax_tpu_torch.models import transformer as tf

CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq=32)
B, T = 4, 32
STEPS = 2
MESHES = [(1, 1, 1), (2, 2, 2)]


def tokens():
    rng = np.random.RandomState(0)
    return rng.randint(0, CFG["vocab"], (B, T)).astype(np.int32)


def _jax_run(shape, steps, dtype="float32"):
    cfg = jtf.GPTConfig(**CFG, dtype=dtype)
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("dp", "tp", "sp"))
    model = jtf.GPT(cfg, mesh)
    params = jtf.init_params(cfg, tp=shape[1], seed=0)
    opt = model.init_opt_state(params)
    step = model.train_step_fn(opt)
    losses = []
    for _ in range(steps):
        loss, params, opt = step(params, opt, jnp.asarray(tokens()))
        losses.append(float(loss))
    return losses, {f: np.asarray(getattr(params, f))
                    for f in jtf.GPTParams._fields}


@pytest.fixture(scope="module")
def jax_runs():
    return {shape: _jax_run(shape, STEPS) for shape in MESHES}


def _port_run(shape, steps, dtype="float32"):
    model = tf.GPT(tf.GPTConfig(**CFG, dtype=dtype), shape, device="cpu")
    losses = [float(model.train_step(torch.from_numpy(tokens())))
              for _ in range(steps)]
    return losses, model


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_init_params_match_jax_bit_for_bit(tp):
    want = jtf.init_params(jtf.GPTConfig(**CFG), tp=tp, seed=3)
    got = tf.init_params(tf.GPTConfig(**CFG), tp=tp, seed=3)
    for f in tf.GPTParams._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    with pytest.raises(ValueError):
        tf.init_params(tf.GPTConfig(n_heads=3), tp=2)


def test_params_from_numpy_round_trips():
    cfg = jtf.GPTConfig(**CFG)
    jparams = jtf.init_params(cfg, tp=2, seed=1)
    got = tf.params_from_numpy(jparams, device="cpu")
    model = tf.GPT(tf.GPTConfig(**CFG), (2, 2, 2), got, device="cpu")
    back = model.global_params()
    for f in tf.GPTParams._fields:
        assert getattr(got, f).dtype == torch.float32
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jparams, f)))
    # one replica or tp block per rank
    assert model.wte.shape == (2, 2, 2, CFG["vocab"], CFG["d_model"])
    assert torch.equal(model.w1[1, 1, 0], got.w1[:, 1])


@pytest.mark.parametrize("shape", MESHES)
def test_two_steps_match_jax(jax_runs, shape):
    want_losses, want = jax_runs[shape]
    losses, model = _port_run(shape, STEPS)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    got = model.global_params()
    for f in tf.GPTParams._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), want[f],
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    # every replica took the same update
    for f in tf.REPLICATED_FIELDS:
        p = getattr(model, f).detach()
        assert torch.equal(p, p[:1, :1, :1].expand_as(p)), f


def _jax_first_loss(dtype):
    """The loss the JAX train step returns on its first step, on a
    (1, 1, 1) mesh: its ``_loss_local`` at the initial parameters, with the
    step's shifted targets and mask (``transformer.py:285-296``), compiled
    without the gradient and the optimizer."""
    cfg = jtf.GPTConfig(**CFG, dtype=dtype)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "tp", "sp"))
    toks = jnp.asarray(tokens())
    targets = jnp.concatenate([toks[:, 1:], jnp.zeros_like(toks[:, :1])], 1)
    mask = jnp.concatenate([jnp.ones(toks[:, 1:].shape, jnp.float32),
                            jnp.zeros(toks[:, :1].shape, jnp.float32)], 1)
    tok = P("dp", "sp")
    loss = jax.jit(jax.shard_map(
        jtf.GPT(cfg, mesh)._loss_local, mesh=mesh,
        in_specs=(jtf.param_specs(), tok, tok, tok), out_specs=P(),
        check_vma=False))
    return float(loss(jtf.init_params(cfg, tp=1, seed=0), toks, targets,
                      mask))


def test_first_bf16_step_loss_matches_jax():
    want = _jax_first_loss("bfloat16")
    (got,), _ = _port_run((1, 1, 1), 1, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 2), (2, 1, 4)])
def test_decomposition_invariance(shape):
    """The same data and parameters give the same first-step loss on any
    mesh (``tests/models/test_transformer.py``'s test): the tp=1
    parameters cut into tp blocks."""
    cfg = tf.GPTConfig(**CFG)
    full = tf.init_params(cfg, tp=1, seed=0)
    tp = shape[1]
    h, hd = CFG["n_heads"], CFG["d_model"] // CFG["n_heads"]

    def reblock(f, arr):
        if f not in tf.TP_FIELDS:
            return arr
        a = arr[:, 0]
        if f == "w_qkv":  # last dim is (3, heads, head_dim): split by heads
            L, d, _ = a.shape
            w = np.split(a.reshape(L, d, 3, h, hd), tp, axis=3)
            return np.stack([b.reshape(L, d, -1) for b in w], axis=1)
        if f in ("w1", "b1"):  # column-sharded
            return np.stack(np.split(a, tp, axis=-1), axis=1)
        return np.stack(np.split(a, tp, axis=1), axis=1)  # row-sharded

    blocks = tf.GPTParams(**{f: reblock(f, getattr(full, f))
                             for f in tf.GPTParams._fields})
    toks = torch.from_numpy(tokens())
    ref = tf.GPT(cfg, (1, 1, 1), full, device="cpu").train_step(toks)
    got = tf.GPT(cfg, shape, blocks, device="cpu").train_step(toks)
    np.testing.assert_allclose(float(got), float(ref), rtol=2e-4)


def test_cli_on_the_cpu(capsys):
    train_gpt.main(["--device", "cpu", "--mesh", "1", "2", "2", "--steps",
                    "2", "--d-model", "32", "--layers", "1", "--heads", "4",
                    "--seq", "16", "--batch", "2", "--json"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mesh"] == [1, 2, 2] and rec["device"] == "cpu"
    # the first step, then the two timed ones
    assert len(rec["losses"]) == 3 and all(np.isfinite(rec["losses"]))
    # --pp runs the pipeline-parallel GPT (tests/test_torch_pp_transformer.py
    # holds it to the JAX package's)
    train_gpt.main(["--device", "cpu", "--pp", "2", "--steps", "1",
                    "--d-model", "16", "--layers", "2", "--heads", "4",
                    "--seq", "16", "--batch", "2", "--json"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["pp"] == 2 and rec["device"] == "cpu"
    assert len(rec["losses"]) == 2 and all(np.isfinite(rec["losses"]))
