"""The fused shallow-water step of the PyTorch port.

- ``fused_step`` on CPU tensors (its plain version) against the JAX
  package's XLA step, at 32x64 and at the edge shapes of
  ``tests/models/test_sw_pallas.py``;
- a torch emulation of ``csrc/sw_step.cu``'s walk (its default tile, a
  window of H = 2*fuse rows and columns around each tile, the modular
  column map, clamping at the window's edge, the ghost-row and wall masks
  and the order of its four passes), run over every tile against the plain
  step, bit for bit: the window depth and masks that the CUDA kernel
  relies on, checked on the CPU.  It runs on the check states of
  ``models/_sw_check.py`` (seeded grid-scale noise, the solver's viscosity
  and 1000x it), where a window one cell per step too shallow, or a
  missing viscous pass, changes the bits;
- the kernel's thread block: every window cell owned by one thread;
- those check states themselves.
The CUDA kernel itself is tested on the card by
``test_torch_sw_kernel_gpu.py``.  The emulation and the check states are
in ``tests/test_torch_sw_kernel_emulation.py`` (two files of at most 45
cases; the JAX step's compile stays here with all its users).

Tolerance: the JAX package's own kernel-vs-XLA tolerance, rtol 2e-5 and
atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from mpi4jax_tpu.models.shallow_water import ShallowWater as JaxShallowWater
from mpi4jax_tpu.models.shallow_water import SWParams as JaxSWParams
from mpi4jax_tpu.parallel.grid import ProcessGrid

from mpi4jax_tpu_torch.models import _sw_check, _sw_kernel
from mpi4jax_tpu_torch.models.shallow_water import (
    ShallowWater,
    SWParams,
    SWState,
    state_from_numpy,
)

RTOL, ATOL = 2e-5, 1e-6
SHAPES = [(32, 64), (16, 32), (22, 32), (70, 32)]
PARAMS = SWParams(dx=5e3, dy=5e3)
CHECK_PARAMS = [PARAMS, _sw_check.StiffParams(dx=5e3, dy=5e3)]


def _assert_state_close(got, ref, what):
    for name, a, b in zip(SWState._fields, got, ref):
        np.testing.assert_allclose(
            np.asarray(a.cpu() if torch.is_tensor(a) else a), np.asarray(b),
            rtol=RTOL, atol=ATOL, err_msg=f"field {name} {what}",
        )


@pytest.fixture(scope="module")
def jax_states():
    """Per shape: the JAX init and the states after 1..5 XLA steps."""
    out = {}
    for ny, nx in SHAPES:
        grid = ProcessGrid((1, 1), devices=jax.devices()[:1])
        model = JaxShallowWater(grid, (ny, nx), JaxSWParams(dx=5e3, dy=5e3))
        first = model.step_fn(1, first=True, impl="xla")
        step = model.step_fn(1, impl="xla")
        states = [model.init()]
        states.append(first(states[0]))
        for _ in range(4):
            states.append(step(states[-1]))
        out[(ny, nx)] = [tuple(np.asarray(f) for f in s) for s in states]
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_euler_step_matches_jax(jax_states, shape):
    ref = jax_states[shape]
    got = _sw_kernel.fused_step(state_from_numpy(ref[0], "cpu"), PARAMS,
                                first=True)
    _assert_state_close(got, ref[1], f"after the Euler step at {shape}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_fused_step_matches_jax(jax_states, shape, fuse):
    ref = jax_states[shape]
    got = _sw_kernel.fused_step(state_from_numpy(ref[2], "cpu"), PARAMS,
                                first=False, fuse=fuse)
    _assert_state_close(got, ref[2 + fuse], f"fuse={fuse} at {shape}")


def test_fused_step_writes_out():
    model = ShallowWater((16, 32), PARAMS, device="cpu")
    s0 = model.init()
    out = SWState(*(torch.empty_like(f) for f in s0))
    got = _sw_kernel.fused_step(s0, PARAMS, first=True, out=out)
    assert all(g is o for g, o in zip(got, out))
    _assert_state_close(got, model._step_local(s0, True), "written to out")


def test_fused_step_rejects_bad_input():
    model = ShallowWater((16, 32), PARAMS, device="cpu")
    s0 = model.init()
    with pytest.raises(ValueError, match="fuse=1"):
        _sw_kernel.fused_step(s0, PARAMS, first=True, fuse=2)
    with pytest.raises(TypeError, match="float32"):
        _sw_kernel.fused_step(SWState(*(f.double() for f in s0)), PARAMS,
                              first=False)
    with pytest.raises(ValueError, match="contiguous"):
        _sw_kernel.fused_step(SWState(*(f.t().contiguous().t() for f in s0)),
                              PARAMS, first=False)
    with pytest.raises(ValueError, match="alias"):
        _sw_kernel.fused_step(s0, PARAMS, first=False, out=s0)
    with pytest.raises(ValueError, match="periodic_x"):
        _sw_kernel.fused_step(s0, PARAMS._replace(periodic_x=False),
                              first=False)
    with pytest.raises(ValueError, match="shared memory"):
        _sw_kernel.fused_step(s0, PARAMS, first=False, fuse=3,
                              tile=(96, 96))


def test_smem_of_default_tile_fits_at_fuse_3():
    # and two blocks share an SM (228 KiB, 1 KiB of it reserved per block)
    need = _sw_kernel.smem_bytes(_sw_kernel.DEFAULT_TILE, 3)
    assert need <= _sw_kernel.SMEM_LIMIT
    assert 2 * (need + 1024) <= 228 * 1024


@pytest.mark.parametrize("tile", [_sw_kernel.DEFAULT_TILE, (16, 16), (1, 1),
                                  (30, 100), (60, 40), (110, 30)])
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_thread_block_owns_every_window_cell_once(tile, fuse):
    # the kernel's thread (x, y) owns window columns x + 32 j and rows
    # y + R i; together they cover the window, no cell twice, no thread
    # past 8 cells
    cols, rows, thread_rows = _sw_kernel.thread_block(tile, fuse)
    wy, wx = _sw_kernel.window(tile, fuse)
    assert cols * rows <= 8 and thread_rows <= _sw_kernel.MAX_THREAD_ROWS
    owned = torch.zeros((thread_rows * rows, _sw_kernel.LANES * cols),
                        dtype=torch.int64)
    for y in range(thread_rows):
        for i in range(rows):
            for j in range(cols):
                owned[y + thread_rows * i,
                      j * _sw_kernel.LANES:(j + 1) * _sw_kernel.LANES] += 1
    assert bool((owned[:wy, :wx] == 1).all())


def test_thread_block_rejects_a_window_it_cannot_cover():
    with pytest.raises(ValueError, match="8 cells"):
        _sw_kernel.thread_block((20, 120), 3)  # 32x132: five cells a row
    with pytest.raises(ValueError, match="8 cells"):
        _sw_kernel.thread_block((70, 80), 1)  # 74x84: 37 rows of threads
    with pytest.raises(ValueError, match="8 cells"):
        _sw_kernel.thread_block((130, 40), 1)  # 134x44: 34 rows of threads
