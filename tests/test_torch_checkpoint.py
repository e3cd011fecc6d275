"""The port's checkpoints held to the JAX package's, on the CPU.

- the cases of ``tests/test_checkpoint.py`` and
  ``tests/test_checkpoint_commit.py`` on the port: round trips of nested
  trees with bf16, ``None`` subtrees, 0-d and empty leaves; mismatch
  errors; legacy format 1; a kill mid-save (single file, and both crash
  points of the sharded commit) leaving the previous committed step
  readable; generation stamps; restores onto another world size;
- files crossing between the packages both ways, bf16 and a nested tree
  with ``None`` included, single-file and sharded (the JAX module is
  loaded through a package shim, as its own tests load it: it needs no
  jax);
- a 2-rank world job (this file is the ranks' program) that saves the
  world solver with ``save_sharded`` at its midpoint and runs on, and a
  second job that restores and finishes bit for bit.

Leaves are compared byte for byte, with their dtypes and shapes.
"""

import importlib
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch.utils import checkpoint as ck
from mpi4jax_tpu_torch.utils.tree import leaves as tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHIM = "m4j_ckpt_shim"
GRID, SHAPE, STEPS = (1, 2), (16, 32), 12


def _jax_checkpoint():
    """The JAX package's checkpoint module, loaded through a private
    package shim (it imports no jax)."""
    if _SHIM not in sys.modules:
        pkg = types.ModuleType(_SHIM)
        pkg.__path__ = [os.path.join(REPO, "mpi4jax_tpu")]
        sys.modules[_SHIM] = pkg
    return importlib.import_module(f"{_SHIM}.utils.checkpoint")


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": [torch.ones(5, dtype=torch.bfloat16) * 1.5,
                   {"bias": torch.tensor(2.25, dtype=torch.float64),
                    "ints": torch.arange(4, dtype=torch.int64),
                    "gap": None}],
        "tup": (torch.tensor(True), torch.zeros(2, 0)),
    }


def _np_tree():
    """``_tree()`` as the JAX package holds it: numpy arrays, bf16 from
    ml_dtypes."""
    import ml_dtypes

    return {
        "w": np.arange(12, dtype=np.float32).reshape(3, 4),
        "nested": [np.full(5, 1.5, np.float32).astype(ml_dtypes.bfloat16),
                   {"bias": np.float64(2.25),
                    "ints": np.arange(4, dtype=np.int64), "gap": None}],
        "tup": (np.array(True), np.zeros((2, 0), np.float32)),
    }


def _bytes(x) -> tuple:
    """(dtype name, shape, bytes) of a tensor or numpy leaf."""
    if isinstance(x, torch.Tensor):
        return (ck._NAMES[x.dtype], tuple(x.shape),
                x.contiguous().reshape(-1).view(torch.uint8).numpy()
                .tobytes())
    x = np.asarray(x)
    return x.dtype.name, x.shape, np.ascontiguousarray(x).tobytes()


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _bytes(x) == _bytes(y)


# -- tests/test_checkpoint.py ------------------------------------------------

def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "nested": [torch.ones(4, dtype=torch.int32),
                       {"b": torch.tensor(3.5)}]}
    path = str(tmp_path / "ckpt")
    ck.save(path, tree)
    assert os.path.exists(path + ".npz")
    _assert_same(tree, ck.restore(path, like=tree))


def test_solver_resume(tmp_path):
    from mpi4jax_tpu_torch.models.shallow_water import (ShallowWater,
                                                        SWParams, SWState)

    model = ShallowWater((16, 32), grid=(2, 4), params=SWParams(dx=5e3,
                                                                dy=5e3),
                         device="cpu")
    step = model.step_fn(5, first=True)
    cont = model.step_fn(5)
    mid = step(model.init())
    full = cont(mid)
    path = str(tmp_path / "sw")
    ck.save(path, mid._asdict())
    restored = SWState(**ck.restore(path, like=mid._asdict()))
    resumed = cont(restored)
    assert np.array_equal(model.interior(resumed.h), model.interior(full.h))


# -- tests/test_checkpoint_commit.py -----------------------------------------

def test_roundtrip_bf16_and_nested_tree(tmp_path):
    tree = _tree()
    path = str(tmp_path / "state.npz")
    ck.save(path, tree)
    out = ck.restore(path, like=tree)
    _assert_same(tree, out)
    assert out["nested"][1]["gap"] is None
    assert isinstance(out["tup"], tuple)


def test_restore_places_leaves_like_the_template(tmp_path):
    path = str(tmp_path / "s.npz")
    ck.save(path, {"a": torch.arange(3.0),
                   "b": torch.ones(2, dtype=torch.bfloat16)})
    out = ck.restore(path, like={"a": torch.zeros(3, dtype=torch.float64),
                                 "b": np.zeros(2)})
    assert out["a"].dtype == torch.float64  # the template's dtype
    assert out["b"].dtype == torch.bfloat16  # as stored: no tensor template


def test_bf16_restores_without_ml_dtypes_or_jax(tmp_path):
    """A bf16 checkpoint written by the JAX package restores in a process
    where neither jax nor ml_dtypes can be imported."""
    jck = _jax_checkpoint()
    path = str(tmp_path / "s.npz")
    jck.save(path, _np_tree())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "from mpi4jax_tpu_torch.utils import checkpoint as ck\n"
        "like = {'w': torch.zeros(3, 4), 'nested': [torch.zeros(5), "
        "{'bias': torch.zeros(()), 'ints': torch.zeros(4), 'gap': None}], "
        "'tup': (torch.zeros(()), torch.zeros(2, 0))}\n"
        "leaves, meta = ck._read_npz(" + repr(path) + ")\n"
        "assert leaves[0].dtype == torch.bfloat16, leaves[0].dtype\n"
        "assert leaves[0].float().tolist() == [1.5] * 5\n"
        "out = ck.restore(" + repr(path) + ", like)\n"
        "assert out['nested'][1]['gap'] is None\n"
        "print('no-ml_dtypes-bf16-ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert "no-ml_dtypes-bf16-ok" in res.stdout


def test_restore_mismatched_tree_errors(tmp_path):
    tree = {"a": torch.zeros(2, 3), "b": torch.ones(4)}
    path = str(tmp_path / "s")
    ck.save(path, tree)
    with pytest.raises(ValueError, match="holds 2 leaves .* has 1"):
        ck.restore(path, like={"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match=r"leaf 0 has shape \(2, 3\)"):
        ck.restore(path, like={"a": torch.zeros(9), "b": torch.ones(4)})


def test_legacy_format1_files_still_read(tmp_path):
    path = str(tmp_path / "old.npz")
    np.savez(path, leaf_0=np.arange(3.0), leaf_1=np.ones((2, 2)))
    out = ck.restore(path, like=[torch.zeros(3), torch.zeros(2, 2)])
    assert out[0].tolist() == [0.0, 1.0, 2.0]
    assert out[1].dtype == torch.float32  # the template's dtype


def test_kill_during_single_file_save_keeps_previous(tmp_path):
    path = str(tmp_path / "state.npz")
    v1 = {"a": torch.arange(4.0)}
    ck.save(path, v1)
    code = (
        f"import os, sys\nsys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "from mpi4jax_tpu_torch.utils import checkpoint as ck\n"
        "os.replace = lambda *a: os._exit(9)  # the kill point\n"
        f"ck.save({path!r}, {{'a': torch.full((4,), 7.0)}})\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 9, res.stderr
    _assert_same(v1, ck.restore(path, like=v1))


def test_sharded_roundtrip_and_generation_stamp(tmp_path):
    tree = _tree()
    ck.save_sharded(tree, step=6, directory=str(tmp_path))
    assert ck.restore_sharded(tree, directory=str(tmp_path))[2][
        "generation"] == 0
    d = ck.save_sharded(tree, step=7, directory=str(tmp_path), generation=3)
    assert os.path.exists(os.path.join(d, "manifest.json"))
    out, step, manifest = ck.restore_sharded(tree, directory=str(tmp_path))
    assert step == 7
    assert manifest["generation"] == 3
    assert manifest["replicated"] is True
    _assert_same(tree, out)


def test_ckpt_dir_knob(tmp_path, monkeypatch):
    monkeypatch.delenv("MPI4JAX_TPU_CKPT_DIR", raising=False)
    with pytest.raises(ValueError, match="MPI4JAX_TPU_CKPT_DIR"):
        ck.save_sharded({"a": torch.ones(1)}, step=1)
    monkeypatch.setenv("MPI4JAX_TPU_CKPT_DIR", str(tmp_path))
    ck.save_sharded({"a": torch.ones(1)}, step=1, keep=1)
    ck.save_sharded({"a": torch.ones(1)}, step=2, keep=1)
    assert ck.committed_steps(str(tmp_path)) == [2]


def test_latest_step_ignores_uncommitted_directories(tmp_path):
    tree = {"a": torch.arange(3.0)}
    ck.save_sharded(tree, step=4, directory=str(tmp_path))
    torn = ck.step_dir(str(tmp_path), 9)
    os.makedirs(torn)
    open(os.path.join(torn, "shard0of1.npz"), "wb").close()
    assert ck.committed_steps(str(tmp_path)) == [4]
    assert ck.latest_step(str(tmp_path)) == 4
    _, step, _ = ck.restore_sharded(tree, directory=str(tmp_path))
    assert step == 4


@pytest.mark.parametrize("crash_point", ["after_shard", "mid_commit"])
def test_kill_during_sharded_save_never_tears(tmp_path, crash_point):
    tree = {"a": torch.arange(6.0), "b": torch.ones(2, 2)}
    ck.save_sharded(tree, step=2, directory=str(tmp_path))
    code = (
        f"import sys\nsys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "from mpi4jax_tpu_torch.utils import checkpoint as ck\n"
        "ck.save_sharded({'a': torch.zeros(6), 'b': torch.zeros(2, 2)}, "
        f"step=3, directory={str(tmp_path)!r}, "
        f"_crash_point={crash_point!r})\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 137, res.stderr
    assert ck.latest_step(str(tmp_path)) == 2
    out, step, _ = ck.restore_sharded(tree, directory=str(tmp_path))
    assert step == 2
    _assert_same(tree, out)


def test_restore_onto_shrunk_world_requires_replicated(tmp_path):
    tree = {"a": torch.arange(3.0)}

    class FakeComm:
        def __init__(self, rank, size):
            self._r, self._s = rank, size

        def rank(self):
            return self._r

        def size(self):
            return self._s

    ck.save_sharded(tree, step=1, directory=str(tmp_path / "rep"))
    out, _, _ = ck.restore_sharded(tree, directory=str(tmp_path / "rep"),
                                   comm=FakeComm(1, 2))
    _assert_same(tree, out)
    ck.save_sharded(tree, step=1, directory=str(tmp_path / "nonrep"),
                    replicated=False)
    with pytest.raises(ValueError, match="resharding is not"):
        ck.restore_sharded(tree, directory=str(tmp_path / "nonrep"),
                           comm=FakeComm(1, 2))


# -- between the packages ----------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_between_the_packages(tmp_path, writer):
    jck = _jax_checkpoint()
    path = str(tmp_path / "x.npz")
    if writer == "jax":
        jck.save(path, _np_tree())
        out = ck.restore(path, like=_tree())
        _assert_same(_tree(), out)
        assert out["nested"][0].dtype == torch.bfloat16
    else:
        ck.save(path, _tree())
        out = jck.restore(path, like=_np_tree())
        _assert_same(_np_tree(), out)
        assert out["nested"][0].dtype.name == "bfloat16"
    assert out["nested"][1]["gap"] is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_checkpoints_cross_between_the_packages(tmp_path, writer):
    jck = _jax_checkpoint()
    if writer == "jax":
        jck.save_sharded(_np_tree(), step=5, directory=str(tmp_path),
                         generation=2)
        out, step, manifest = ck.restore_sharded(_tree(),
                                                 directory=str(tmp_path))
        _assert_same(_tree(), out)
    else:
        ck.save_sharded(_tree(), step=5, directory=str(tmp_path),
                        generation=2)
        out, step, manifest = jck.restore_sharded(_np_tree(),
                                                  directory=str(tmp_path))
        _assert_same(_np_tree(), out)
    assert step == 5 and manifest["generation"] == 2
    assert jck.committed_steps(str(tmp_path)) == \
        ck.committed_steps(str(tmp_path)) == [5]


# -- the world solver across two jobs -----------------------------------------

def _rank_main(mode, directory, out):
    """One rank: ``save`` runs the solver, saves at its midpoint and runs
    on; ``resume`` restores the midpoint and finishes.  Rank 0 writes the
    final fields to ``out``."""
    from mpi4jax_tpu_torch.models.shallow_water_world import \
        WorldShallowWater
    from mpi4jax_tpu_torch.models.shallow_water import SWState
    from mpi4jax_tpu_torch.runtime import transport

    torch.set_num_threads(1)
    comm = transport.get_world_comm(device="cpu")
    model = WorldShallowWater(comm, GRID, SHAPE)
    half = STEPS // 2
    if mode == "save":
        state = model.step_fn(half, first=True)(model.init())
        ck.save_sharded(state._asdict(), step=half, directory=directory,
                        comm=comm, replicated=False)
    else:
        like = {k: torch.empty(model.block_shape)
                for k in SWState._fields}
        tree, step, manifest = ck.restore_sharded(like, directory=directory,
                                                  comm=comm)
        assert step == half and manifest["nshards"] == comm.size()
        state = SWState(**tree)
    state = model.step_fn(STEPS - half)(state)
    fields = {k: model.gather_global(getattr(state, k)) for k in "huv"}
    if comm.rank() == 0:
        np.savez(out, **fields)


def test_world_solver_resumes_bit_for_bit_in_a_second_job(tmp_path,
                                                          monkeypatch):
    from mpi4jax_tpu_torch.runtime import launch

    monkeypatch.setenv("PYTHONPATH", REPO)
    outs = {}
    for mode in ("save", "resume"):
        outs[mode] = str(tmp_path / f"{mode}.npz")
        rc = launch.main(["-n", str(GRID[0] * GRID[1]), "--timeout", "60",
                          os.path.abspath(__file__), mode,
                          str(tmp_path / "ckpt"), outs[mode]])
        assert rc == 0, mode
    assert ck.committed_steps(str(tmp_path / "ckpt")) == [STEPS // 2]
    a, b = np.load(outs["save"]), np.load(outs["resume"])
    for k in "huv":
        assert a[k].shape == SHAPE
        assert a[k].tobytes() == b[k].tobytes(), k


if __name__ == "__main__":
    _rank_main(*sys.argv[1:4])
