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
``test_torch_sw_kernel_gpu.py``.

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


# -- torch emulation of csrc/sw_step.cu ------------------------------------

def _n(a):  # row + 1, clamped at the window edge
    return torch.cat([a[1:], a[-1:]], 0)


def _s(a):  # row - 1
    return torch.cat([a[:1], a[:-1]], 0)


def _e(a):  # column + 1
    return torch.cat([a[:, 1:], a[:, -1:]], 1)


def _w(a):  # column - 1
    return torch.cat([a[:, :1], a[:, :-1]], 1)


def _window_steps(win, gr, nyp, p, a, b, fuse):
    """``fuse`` steps on one window, pass for pass as the CUDA kernel."""
    h, u, v, dh, du, dv = win
    interior = (gr >= 1) & (gr <= nyp - 2)
    wall = gr == nyp - 2
    zero = torch.zeros(())
    dx, dy, g, nu, dt = p.dx, p.dy, p.gravity, p.viscosity, p.dt
    f = p.coriolis_f + p.coriolis_beta * ((gr - 1).float() * dy)

    def live(x):  # a pass writes the interior rows; ghost rows stay zero
        return torch.where(interior, x, zero)

    for _ in range(fuse):
        # fluxes: hc is h, but the wall row's north hc is its own h
        hcn = torch.where(wall, h, _n(h))
        hcne = torch.where(wall, _e(h), _n(_e(h)))
        fe = live(0.5 * (h + _e(h)) * u)
        fn = live(torch.where(wall, zero, 0.5 * (h + hcn) * v))
        zeta = (_e(v) - v) / dx - (_n(u) - u) / dy
        q = live((f + zeta) / (0.25 * (h + _e(h) + hcn + hcne)))
        ke = live(0.5 * (0.5 * (u * u + _w(u) * _w(u))
                         + 0.5 * (v * v + _s(v) * _s(v))))
        # tendencies; u and v update in place, the new h waits
        dh_new = -(fe - _w(fe)) / dx - (fn - _s(fn)) / dy
        du_new = (-g * (_e(h) - h) / dx
                  + 0.5 * (q * 0.5 * (fn + _e(fn))
                           + _s(q) * 0.5 * (_s(fn) + _s(_e(fn))))
                  - (_e(ke) - ke) / dx)
        dv_new = (-g * (_n(h) - h) / dy
                  - 0.5 * (q * 0.5 * (fe + _n(fe))
                           + _w(q) * 0.5 * (_w(fe) + _n(_w(fe))))
                  - (_n(ke) - ke) / dy)
        h_new = torch.where(interior, h + dt * (a * dh_new + b * dh), h)
        u = torch.where(interior, u + dt * (a * du_new + b * du), u)
        v = torch.where(wall, zero,
                        torch.where(interior, v + dt * (a * dv_new + b * dv),
                                    v))
        dh, du, dv = (torch.where(interior, t, d) for t, d in
                      ((dh_new, dh), (du_new, du), (dv_new, dv)))
        # viscous fluxes, and h takes its new value
        gxu = live(nu * (_e(u) - u) / dx)
        gyu = live(torch.where(wall, zero, nu * (_n(u) - u) / dy))
        gxv = live(nu * (_e(v) - v) / dx)
        gyv = live(torch.where(wall, zero, nu * (_n(v) - v) / dy))
        h = h_new
        # viscous update
        u = torch.where(interior, u + dt * ((gxu - _w(gxu)) / dx
                                            + (gyu - _s(gyu)) / dy), u)
        v = torch.where(wall, zero,
                        torch.where(interior,
                                    v + dt * ((gxv - _w(gxv)) / dx
                                              + (gyv - _s(gyv)) / dy), v))
    return h, u, v, dh, du, dv


def emulate_kernel(state, p, *, first, fuse, tile=_sw_kernel.DEFAULT_TILE,
                   halo_per_step=_sw_kernel.HALO_PER_STEP):
    """What ``sw_fused_step`` computes, one tile window at a time."""
    nyp, X = state[0].shape
    nx = X - 2
    halo = halo_per_step * fuse
    ty, tx = tile
    a, b = (1.0, 0.0) if first else (p.ab_a, p.ab_b)
    out = [torch.zeros_like(f) for f in state]
    for r0 in range(0, nyp, ty):
        for c0 in range(0, X, tx):
            gr = torch.arange(r0 - halo, r0 + ty + halo)[:, None]
            rows = gr[:, 0].clamp(0, nyp - 1)
            cols = 1 + (torch.arange(c0 - halo, c0 + tx + halo) - 1) % nx
            win = [f[rows][:, cols] for f in state]
            res = _window_steps(win, gr, nyp, p, a, b, fuse)
            r1, c1 = min(r0 + ty, nyp), min(c0 + tx, X)
            body = (slice(halo, halo + r1 - r0), slice(halo, halo + c1 - c0))
            for o, r in zip(out, res):
                o[r0:r1, c0:c1] = r[body]
    interior = torch.zeros((nyp, X), dtype=torch.bool)
    interior[1:-1, 1:-1] = True
    for k in (3, 4, 5):
        out[k] = torch.where(interior, out[k], torch.zeros(()))
    return SWState(*out)


def _assert_state_equal(got, ref, what):
    # the emulation repeats the plain step's arithmetic operation for
    # operation, so on the CPU the two agree bit for bit
    for name, a, b in zip(SWState._fields, got, ref):
        assert torch.equal(a, b), (
            f"field {name} {what}: max diff {(a - b).abs().max().item()}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_tile_emulation_matches_plain(shape, fuse):
    for params in CHECK_PARAMS:
        _, (s2, _, _) = _sw_check.cases(shape, params, "cpu", (fuse,))
        got = emulate_kernel(s2, params, first=False, fuse=fuse)
        ref = _sw_kernel.fused_step_plain(s2, params, first=False, fuse=fuse)
        _assert_state_equal(got, ref, f"emulated fuse={fuse} at {shape}")


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_emulation_euler_step(shape):
    for params in CHECK_PARAMS:
        [(s0, _, _)] = _sw_check.cases(shape, params, "cpu", ())
        got = emulate_kernel(s0, params, first=True, fuse=1)
        ref = _sw_kernel.fused_step_plain(s0, params, first=True)
        _assert_state_equal(got, ref, f"emulated Euler step at {shape}")


@pytest.mark.parametrize("shape", SHAPES)
def test_tile_emulation_matches_plain_at_half_the_halo(shape):
    # one step's dependence cone reaches 2 cells from a cell (the viscous
    # pass reads the updated u, v one cell beyond the tendencies' reach):
    # half the first kernel's 4 per step, and the kernel's window now; here
    # over 16x16 tiles, where most windows meet a ghost row or a wrap
    for params in CHECK_PARAMS:
        for s, first, fuse in _sw_check.cases(shape, params, "cpu", (1, 3)):
            got = emulate_kernel(s, params, first=first, fuse=fuse,
                                 tile=(16, 16), halo_per_step=2)
            ref = _sw_kernel.fused_step_plain(s, params, first=first,
                                              fuse=fuse)
            _assert_state_equal(got, ref, f"halo 2 per step, fuse={fuse}")


@pytest.mark.parametrize("shape", [(32, 64), (70, 32)])
def test_tile_emulation_one_cell_per_step_too_shallow_changes_the_bits(shape):
    """A window of 1 cell per step changes the bits at fuse 1 and 3 on the
    stiff check state.  Its error over scale (``_sw_check.errors``, 16x16
    tiles, 32x64 and 70x32) is 2.5e-3 to 4.7e-3 at fuse=1 but only 0 to
    8.2e-6 at fuse=3, far under ``CHECK_TOL`` (2e-4) and the kernel's own
    rounding (1.26e-5): at fuse > 1 the card's tolerance check cannot see a
    window this shallow, and only this bit-for-bit emulation guards the
    window's depth."""
    stiff = CHECK_PARAMS[1]
    for s, first, fuse in _sw_check.cases(shape, stiff, "cpu", (1, 3)):
        if first:
            continue
        for tile in ((16, 16), _sw_kernel.DEFAULT_TILE):
            got = emulate_kernel(s, stiff, first=False, fuse=fuse, tile=tile,
                                 halo_per_step=1)
            ref = _sw_kernel.fused_step_plain(s, stiff, first=False,
                                              fuse=fuse)
            assert not all(torch.equal(a, b) for a, b in zip(got, ref)), (
                f"a window of 1 per step kept the bits at fuse={fuse}, "
                f"tile {tile}")


# -- the check states --------------------------------------------------------

class _Inviscid(SWParams):
    __slots__ = ()
    viscosity = 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_check_states_make_the_viscous_pass_visible(shape):
    # at 1000x the viscosity, leaving the viscous pass out moves u or v by
    # far more than CHECK_TOL of the step's change
    stiff = CHECK_PARAMS[1]
    for s, first, fuse in _sw_check.cases(shape, stiff, "cpu", (1, 3)):
        ref = _sw_kernel.fused_step_plain(s, stiff, first=first, fuse=fuse)
        without = _sw_kernel.fused_step_plain(
            s, _Inviscid(*stiff), first=first, fuse=fuse)
        worst = max(rel for _, rel in _sw_check.errors(without, ref, s))
        assert worst > 10 * _sw_check.CHECK_TOL, (first, fuse, worst)


def test_check_state_keeps_the_solver_invariants():
    model = ShallowWater((22, 32), PARAMS, device="cpu")
    s = _sw_check.check_state(model, seed=3)
    assert torch.equal(_sw_check.check_state(model, seed=3).u, s.u)
    init = model.init()
    for f, f0, amp in zip(s[:3], init[:3], _sw_check.NOISE):
        noise = (f - f0)[1:-1, 1:-1]
        assert 0.5 * amp < noise.abs().max() <= 1.001 * amp
        assert torch.equal(f[:, 0], f[:, -2])  # x-periodic ghost columns
        assert torch.equal(f[:, -1], f[:, 1])
        assert torch.equal(f[0], f0[0])  # ghost rows kept
    assert not s.v[-2].any()  # the north wall
    assert not any(f.any() for f in s[3:])
