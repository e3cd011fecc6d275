"""Nonlinear shallow-water solver on torch tensors (single block).

The counterpart of ``mpi4jax_tpu/models/shallow_water.py``: the same
physical setup (Sadourny energy-conserving C-grid scheme, geostrophic-jet
initial condition, Adams–Bashforth-2 with offset 0.1, CFL
dt = 0.125·dx/√(gH), periodic in x, walls in y, lateral viscosity
1e-3·f·dx²) and the same stencils, line for line.

Only the single-block (1x1 grid) case is ported so far.  There the JAX
solver's collectives are single-rank identities and its halo exchange is a
local column wrap, so this module needs no communication.  Decomposed
grids arrive with the port of ``MeshComm`` and ``ProcessGrid``.

A state is six f32 tensors of shape ``(ny+2, nx+2)`` (one ghost ring).
``step_fn`` advances it through the plain PyTorch step (``_step_local``)
or through the fused CUDA kernel (``_sw_kernel.fused_step``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from . import _sw_kernel


class SWParams(NamedTuple):
    dx: float
    dy: float
    gravity: float = 9.81
    depth: float = 100.0
    coriolis_f: float = 2e-4
    coriolis_beta: float = 2e-11
    day_seconds: float = 86_400.0
    ab_a: float = 1.6  # Adams–Bashforth 1.5 + offset
    ab_b: float = -0.6
    periodic_x: bool = True

    @property
    def dt(self) -> float:
        return 0.125 * min(self.dx, self.dy) / float(
            np.sqrt(self.gravity * self.depth)
        )

    @property
    def viscosity(self) -> float:
        return 1e-3 * self.coriolis_f * self.dx**2


class SWState(NamedTuple):
    h: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    dh: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor


# stencil views on a 1-cell halo-padded block
def _C(a):
    return a[..., 1:-1, 1:-1]


def _E(a):
    return a[..., 1:-1, 2:]


def _W(a):
    return a[..., 1:-1, :-2]


def _N(a):
    return a[..., 2:, 1:-1]


def _S(a):
    return a[..., :-2, 1:-1]


def _NE(a):
    return a[..., 2:, 2:]


def _SE(a):
    return a[..., :-2, 2:]


def _NW(a):
    return a[..., 2:, :-2]


def _pad(interior):
    return F.pad(interior, (1, 1, 1, 1))


def _edge_pad(interior):
    return F.pad(interior[None], (1, 1, 1, 1), mode="replicate")[0]


def _embed(old, interior):
    """``old`` with a new interior; its ghost ring is kept (the wall ghosts
    persist across steps, the exchange refreshes the others)."""
    out = old.clone()
    out[1:-1, 1:-1] = interior
    return out


def state_from_numpy(arrays, device) -> SWState:
    """A state from six ``(ny+2, nx+2)`` arrays, such as the JAX solver's
    state converted with ``np.asarray``."""
    dev = resolve_device(device)
    return SWState(*(
        torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
        for a in arrays
    ))


def state_to_numpy(state: SWState) -> SWState:
    """The state as six numpy arrays, for handing to the JAX solver."""
    return SWState(*(f.detach().cpu().numpy() for f in state))


class ShallowWater:
    """Shallow-water solver on one block of ``(ny+2, nx+2)`` tensors.

    ``global_shape = (ny, nx)`` is the physical (unpadded) domain.  ``grid``
    may only be ``None`` or ``(1, 1)`` until decomposed grids are ported.
    ``device`` defaults to ``cuda:0``; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, global_shape, params: Optional[SWParams] = None, *,
                 grid=None, device=None):
        if grid is not None and tuple(grid) != (1, 1):
            raise ValueError(
                f"grid {tuple(grid)} is not supported: only the single-block "
                "1x1 grid is ported"
            )
        self.ny, self.nx = (int(n) for n in global_shape)
        if self.ny < 1 or self.nx < 1:
            raise ValueError(f"empty domain {tuple(global_shape)}")
        self.params = params or SWParams(dx=5e3, dy=5e3)
        self.device = resolve_device(device)
        self.block_shape = (self.ny + 2, self.nx + 2)
        self._coords = None

    # -- coordinate fields ---------------------------------------------------
    def _local_coords(self):
        if self._coords is None:
            p = self.params
            jy = torch.arange(-1, self.ny + 1, device=self.device)
            jx = torch.arange(-1, self.nx + 1, device=self.device)
            y = jy.to(torch.float32) * p.dy
            x = jx.to(torch.float32) * p.dx
            self._coords = torch.meshgrid(y, x, indexing="ij")
        return self._coords

    def _coriolis(self, yy):
        p = self.params
        return p.coriolis_f + yy * p.coriolis_beta

    # -- boundary handling ---------------------------------------------------
    def _exchange(self, fields, kinds):
        """The 1x1 halo exchange plus the physical wall conditions.

        x-periodic: ghost column 0 takes column nx and ghost column nx+1
        takes column 1, over the full height; the y ghosts are kept.  Then
        "v" fields get the no-normal-flow wall at the north boundary and
        "u" fields a wall at the east when x is not periodic.
        """
        p = self.params
        out = []
        for f, kind in zip(fields, kinds):
            f = f.clone()
            if p.periodic_x:
                lo, hi = f[:, 1].clone(), f[:, -2].clone()
                f[:, 0] = hi
                f[:, -1] = lo
            if kind == "v":
                f[-2, :] = 0.0
            elif kind == "u" and not p.periodic_x:
                f[:, -2] = 0.0
            out.append(f)
        return out

    # -- initial conditions --------------------------------------------------
    def init(self) -> SWState:
        """The initial state on the model's device: the geostrophic jet of
        the reference setup (the JAX solver's ``_initial_local`` on one
        rank)."""
        p = self.params
        yy, xx = self._local_coords()
        ly = self.ny * p.dy
        lx = self.nx * p.dx

        u0 = 10.0 * torch.exp(-((yy - 0.5 * ly) ** 2) / (0.02 * lx) ** 2)
        v0 = torch.zeros_like(u0)

        # h in geostrophic balance: h(y) = -(1/g)∫ f·u dy.  On one rank the
        # cross-rank prefix (a scan) adds nothing and the global sum is
        # the local one.
        integrand = -p.dy * u0 * self._coriolis(yy) / p.gravity
        h_int = torch.cumsum(integrand[1:-1, 1:-1], dim=0)
        h_int = h_int - torch.sum(h_int) / float(self.ny * self.nx)

        h_int = (
            p.depth
            + h_int
            + 0.2
            * torch.sin(_C(xx) / lx * 10 * math.pi)
            * torch.cos(_C(yy) / ly * 8 * math.pi)
        )

        h0 = _edge_pad(h_int)
        h0, u0, v0 = self._exchange((h0, u0, v0), ("h", "u", "v"))
        zero = torch.zeros(self.block_shape, dtype=torch.float32,
                           device=self.device)
        return SWState(h0, u0, v0, zero, zero.clone(), zero.clone())

    # -- dynamics ------------------------------------------------------------
    def _step_local(self, state: SWState, first: bool) -> SWState:
        """One plain step; the oracle the fused kernel is held against."""
        p = self.params
        dt = p.dt
        dx, dy, g = p.dx, p.dy, p.gravity
        h, u, v, dh, du, dv = state

        (hc,) = self._exchange((_edge_pad(_C(h)),), ("h",))

        fe = _pad(0.5 * (_C(hc) + _E(hc)) * _C(u))
        fn = _pad(0.5 * (_C(hc) + _N(hc)) * _C(v))
        yy, _ = self._local_coords()
        zeta = (_E(v) - _C(v)) / dx - (_N(u) - _C(u)) / dy
        thickness = 0.25 * (_C(hc) + _E(hc) + _N(hc) + _NE(hc))
        q = _pad((self._coriolis(_C(yy)) + zeta) / thickness)
        ke = _pad(
            0.5
            * (
                0.5 * (_C(u) ** 2 + _W(u) ** 2)
                + 0.5 * (_C(v) ** 2 + _S(v) ** 2)
            )
        )
        fe, fn, q, ke = self._exchange(
            (fe, fn, q, ke), ("u", "v", "h", "h")
        )

        dh_new = -(_C(fe) - _W(fe)) / dx - (_C(fn) - _S(fn)) / dy

        du_new = -g * (_E(h) - _C(h)) / dx + 0.5 * (
            _C(q) * 0.5 * (_C(fn) + _E(fn))
            + _S(q) * 0.5 * (_S(fn) + _SE(fn))
        )
        dv_new = -g * (_N(h) - _C(h)) / dy - 0.5 * (
            _C(q) * 0.5 * (_C(fe) + _N(fe))
            + _W(q) * 0.5 * (_W(fe) + _NW(fe))
        )
        du_new = du_new - (_E(ke) - _C(ke)) / dx
        dv_new = dv_new - (_N(ke) - _C(ke)) / dy

        if first:
            h = _embed(h, _C(h) + dt * dh_new)
            u = _embed(u, _C(u) + dt * du_new)
            v = _embed(v, _C(v) + dt * dv_new)
        else:
            h = _embed(h, _C(h) + dt * (p.ab_a * dh_new + p.ab_b * _C(dh)))
            u = _embed(u, _C(u) + dt * (p.ab_a * du_new + p.ab_b * _C(du)))
            v = _embed(v, _C(v) + dt * (p.ab_a * dv_new + p.ab_b * _C(dv)))
        h, u, v = self._exchange((h, u, v), ("h", "u", "v"))

        if p.viscosity > 0:
            nu = p.viscosity
            gx_u = _pad(nu * (_E(u) - _C(u)) / dx)
            gy_u = _pad(nu * (_N(u) - _C(u)) / dy)
            gx_v = _pad(nu * (_E(v) - _C(v)) / dx)
            gy_v = _pad(nu * (_N(v) - _C(v)) / dy)
            gx_u, gy_u, gx_v, gy_v = self._exchange(
                (gx_u, gy_u, gx_v, gy_v), ("u", "v", "u", "v")
            )
            u = _embed(
                u,
                _C(u)
                + dt
                * (
                    (_C(gx_u) - _W(gx_u)) / dx
                    + (_C(gy_u) - _S(gy_u)) / dy
                ),
            )
            v = _embed(
                v,
                _C(v)
                + dt
                * (
                    (_C(gx_v) - _W(gx_v)) / dx
                    + (_C(gy_v) - _S(gy_v)) / dy
                ),
            )
            h, u, v = self._exchange((h, u, v), ("h", "u", "v"))

        return SWState(
            h, u, v, _pad(dh_new), _pad(du_new), _pad(dv_new)
        )

    # -- public entry points -------------------------------------------------
    def step_fn(self, n_steps: int, first: bool = False, impl: str = "auto",
                fuse: int = 3, tile=None):
        """A function advancing a state ``n_steps`` steps.

        ``impl``: "plain" runs ``_step_local``; "kernel" runs the fused CUDA
        kernel and raises on a CPU state; "auto" picks the kernel for a CUDA
        state and the plain step for a CPU state.  There is no fallback.

        On the kernel path ``first=True`` starts with one Euler step
        (fuse=1), then come whole calls of ``fuse`` steps each and single
        steps for the remainder.  The kernel writes into two state buffers
        that the function owns and alternates between, so after the first
        call it allocates nothing.  The state it returns is one of those
        buffers and is overwritten by its next call unless passed back in.
        ``tile`` is the kernel's ``(rows, cols)`` output tile.
        """
        if impl not in ("auto", "plain", "kernel"):
            raise ValueError(f"unknown impl {impl!r}")
        if fuse < 1:
            raise ValueError(f"fuse must be >= 1, got {fuse}")
        params = self.params
        buffers = []

        def plain(state):
            s = state
            remaining = n_steps
            if first and remaining > 0:
                s = self._step_local(s, True)
                remaining -= 1
            for _ in range(remaining):
                s = self._step_local(s, False)
            return s

        def launch(s, is_first, steps):
            if not buffers:
                buffers.extend(
                    SWState(*(torch.empty_like(f) for f in s))
                    for _ in range(2)
                )
            out = buffers[1] if s.h.data_ptr() == buffers[0].h.data_ptr() \
                else buffers[0]
            return _sw_kernel.fused_step(s, params, first=is_first,
                                         fuse=steps, out=out, tile=tile)

        def kernel(state):
            if not state.h.is_cuda:
                raise ValueError(
                    "impl='kernel' needs a CUDA state; the state is on "
                    f"{state.h.device}"
                )
            s = state
            remaining = n_steps
            if first and remaining > 0:
                s = launch(s, True, 1)
                remaining -= 1
            whole, rest = divmod(remaining, fuse)
            for _ in range(whole):
                s = launch(s, False, fuse)
            for _ in range(rest):
                s = launch(s, False, 1)
            return s

        def run(state):
            state = SWState(*state)
            if impl == "plain" or (impl == "auto" and not state.h.is_cuda):
                return plain(state)
            return kernel(state)

        return run

    def interior(self, field) -> np.ndarray:
        """The physical ``(ny, nx)`` field as a numpy array."""
        return field[1:-1, 1:-1].detach().cpu().numpy()

    def total_mass(self, state: SWState) -> float:
        h = self.interior(state.h)
        return float(np.sum(h, dtype=np.float64) * self.params.dx
                     * self.params.dy)
