"""The elastic DP GPT on the CPU: ``tests/torch_world_programs/
gpt_dp_elastic.py`` at the JAX program's small width (vocab 64, d_model 32,
2 layers, 4 heads, T 16, d_ff 128, f32; a global batch of 6, 8 SGD steps at
lr 0.05, a commit every 2), through ``parallel.dp.elastic_step_fn`` and
``elastic.training.run``.

- np 3, uninterrupted, and np 3 with slot 1 killed at the start of step 5
  (after the commit of step 4, so step 4 is replayed), shrinking to np 2:
  the final full-batch loss within the JAX package's documented bound,
  1e-2 relative (``tests/world/test_elastic.py``'s ``LOSS_REL_BOUND``),
  and the final parameters within ``PARAM_REL_BOUND`` of the
  uninterrupted run's, in L2 over every field and relative to how far
  training moved them (the shrunk world adds its ranks' gradients in
  another order).  The loss bound cannot tell a bad recovery: on random
  tokens eight steps move the loss by 0.3%.  The parameter bound can: a
  sound recovery read 4.8e-7, one that skipped the replayed step 0.30,
  applied it twice 0.26, and trained its last steps on 4 of the 6
  sequences 0.43 (copies of the code with those faults planted).
- The killed run's ``--route-check``: on the CPU both routes are the plain
  versions, so each generation's check must agree bit for bit.
- The uninterrupted run against the JAX package's GPT
  (``mpi4jax_tpu/models/transformer.py``, its ``_loss_local`` on a
  (1, 1, 1) mesh) trained by SGD on the global batch's mean gradient in
  one process, from the same initial parameters (``init_params``, the same
  draws in both packages): every final parameter within rtol 1e-5 and
  atol 1e-6, and the final loss within rtol 1e-5 (read: parameters within
  6e-8, the losses equal to the printed digits).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from mpi4jax_tpu_torch.runtime.transport import _free_port_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = os.path.join(REPO, "tests", "torch_world_programs",
                       "gpt_dp_elastic.py")
LOSS_REL_BOUND = 1e-2
PARAM_REL_BOUND = 1e-4
STEPS, BATCH, LR = 8, 6, 0.05
CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=128,
           max_seq=16, dtype="float32")


def _job(tmp, name, extra=()):
    env = dict(os.environ, MPI4JAX_TPU_DISABLE_SHM="1",
               MPI4JAX_TPU_TIMEOUT_S="20", MPI4JAX_TPU_ELASTIC_GRACE_S="20",
               MPI4JAX_TPU_CKPT_DIR=str(tmp / f"ck_{name}"))
    env.pop("MPI4JAX_TPU_FAULT", None)
    return subprocess.Popen(
        [sys.executable, "-m", "mpi4jax_tpu_torch.runtime.launch", "-n", "3",
         "--port", str(_free_port_block(9)), "--timeout", "200",
         "--elastic", PROGRAM, "--device", "cpu", "--steps", str(STEPS),
         "--out", str(tmp / f"{name}.npz"), *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _jax_sgd():
    """The JAX GPT trained by SGD on the global batch in one process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from mpi4jax_tpu.models import transformer as jtf

    cfg = jtf.GPTConfig(**CFG)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "tp", "sp"))
    tok = P("dp", "sp")
    loss = jax.shard_map(jtf.GPT(cfg, mesh)._loss_local, mesh=mesh,
                         in_specs=(jtf.param_specs(), tok, tok, tok),
                         out_specs=P(), check_vma=False)
    step = jax.jit(lambda p, *b: jax.tree.map(
        lambda a, g: a - LR * g, p, jax.grad(loss)(p, *b)))

    def batch(s):
        t = jnp.asarray(np.random.RandomState(1000 + s).randint(
            0, CFG["vocab"], size=(BATCH, CFG["max_seq"])), jnp.int32)
        return (t, jnp.concatenate([t[:, 1:], jnp.zeros_like(t[:, :1])], 1),
                jnp.concatenate([jnp.ones(t[:, 1:].shape, jnp.float32),
                                 jnp.zeros(t[:, :1].shape, jnp.float32)], 1))

    params = jtf.init_params(cfg, tp=1, seed=0)
    for s in range(STEPS):
        params = step(params, *batch(s))
    final = float(jax.jit(loss)(params, *batch(STEPS)))
    return final, {f: np.asarray(getattr(params, f))
                   for f in jtf.GPTParams._fields}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_gpt")
    procs = {"clean": _job(tmp, "clean"),
             "fault": _job(tmp, "fault", ("--kill", "1:5", "--route-check"))}
    out = {"jax": _jax_sgd(), "tmp": tmp}  # while the jobs run
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-2500:]
        m = re.search(r"gpt_dp_elastic final_loss (\S+)", stdout)
        assert m, stdout[-2000:]
        out[name] = (float(m.group(1)), stdout, stderr)
    return out


def _lines(stdout, kind="step"):
    return [json.loads(m) for m in re.findall(
        rf"gpt_dp_elastic {kind} (\{{.*\}})", stdout)]


def _number(stdout, name):
    return float(re.search(rf"gpt_dp_elastic {name} (\S+)", stdout).group(1))


def test_loss_parity_across_a_shrink(runs):
    loss_clean = runs["clean"][0]
    loss_fault, stdout, stderr = runs["fault"]
    assert "completed after recovery" in stderr
    resumed = [int(k) for k in re.findall(r"resuming from step (\d+)",
                                          stderr)]
    assert resumed and all(0 < k < STEPS for k in resumed), stderr[-1500:]
    rel = abs(loss_fault - loss_clean) / abs(loss_clean)
    assert rel <= LOSS_REL_BOUND, (loss_clean, loss_fault, rel)
    # the steps after the recovery ran on np 2, resharding the batch, from
    # a step that generation 0 had finished
    steps = _lines(stdout)
    after = [s for s in steps if s["generation"] == 1]
    assert after and {s["size"] for s in after} == {2}
    assert sorted({s["step"] for s in after}) == \
        list(range(min(resumed), STEPS))
    assert min(resumed) in {s["step"] for s in steps
                            if s["generation"] == 0}
    assert "gpt_dp_elastic fail" in stdout


def test_parameters_match_across_a_shrink(runs):
    clean, fault = (np.load(runs["tmp"] / f"{n}.npz")
                    for n in ("clean", "fault"))
    stdout = runs["clean"][1]
    movement = _number(stdout, "movement")
    # training moved the loss and the parameters; a lost or repeated
    # step moves them by one update, far past the bound
    assert _number(stdout, "initial_loss") > runs["clean"][0]
    least = min(s["update_l2"] for s in _lines(stdout)) / movement
    assert least > 1e3 * PARAM_REL_BOUND, least
    diff = sum(float(np.square(fault[f].astype(np.float64) - clean[f]).sum())
               for f in clean.files) ** 0.5
    assert diff / movement <= PARAM_REL_BOUND, (diff, movement)


def test_route_check_runs_in_each_generation(runs):
    checks = _lines(runs["fault"][1], "route")
    assert sorted((c["generation"], c["rank"]) for c in checks) == \
        [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]
    assert all(c["sync_bits"] and c["grad_rel"] == 0.0
               and c["loss_rel"] == 0.0 for c in checks), checks


def test_clean_run_matches_jax_sgd(runs):
    want_loss, want = runs["jax"]
    np.testing.assert_allclose(runs["clean"][0], want_loss, rtol=1e-5)
    got = np.load(runs["tmp"] / "clean.npz")
    for f, w in want.items():
        assert got[f].shape == w.shape, f
        np.testing.assert_allclose(got[f], w, rtol=1e-5, atol=1e-6,
                                   err_msg=f)
