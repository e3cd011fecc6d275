"""A torch emulation of ``csrc/sw_step.cu``'s walk, held to the plain
step bit for bit on the CPU, and the check states it runs on (a part of
``tests/test_torch_sw_kernel.py``).

``emulate_kernel`` follows the kernel's default tile, a window of H =
2*fuse rows and columns around each tile, the modular column map,
clamping at the window's edge, the ghost-row and wall masks and the order
of its four passes, over every tile: the window depth and masks that the
CUDA kernel relies on, checked on the CPU.  It runs on the check states of
``models/_sw_check.py`` (seeded grid-scale noise, the solver's viscosity
and 1000x it), where a window one cell per step too shallow, or a missing
viscous pass, changes the bits.
"""

import pytest
import torch

from mpi4jax_tpu_torch.models import _sw_check, _sw_kernel
from mpi4jax_tpu_torch.models.shallow_water import (ShallowWater, SWParams,
                                                    SWState)
from test_torch_sw_kernel import CHECK_PARAMS, PARAMS, SHAPES  # noqa: F401


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
