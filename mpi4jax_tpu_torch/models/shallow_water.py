"""Nonlinear shallow-water solver on torch tensors, over a 2-D process grid.

The counterpart of ``mpi4jax_tpu/models/shallow_water.py``: the same
physical setup (Sadourny energy-conserving C-grid scheme, geostrophic-jet
initial condition, Adams–Bashforth-2 with offset 0.1, CFL
dt = 0.125·dx/√(gH), periodic in x, walls in y, lateral viscosity
1e-3·f·dx²) and the same stencils, line for line.

Layout.  On the single-block (1x1) grid a state is six f32 tensors of shape
``(ny+2, nx+2)`` (one ghost ring).  On a decomposed ``(gy, gx)`` grid every
rank lives on the one device and the grid's axes lead
(``parallel/mesh.py``): a field is ``(gy, gx, ny/gy + 2, nx/gx + 2)`` and
each rank's block is contiguous.  ``state_from_numpy``/``state_to_numpy``
convert from and to the JAX package's stacked-block layout
``(gy·(ny/gy+2), gx·(nx/gx+2))``.

The stencils use ``...`` and run batched over the rank axes.  The halo
exchange is ``parallel/halo.py``'s: on a decomposed grid each call moves
the strips of every field with one ``ring_shift2`` per grid axis, one
launch of the hop kernel on the card.  The initial condition uses the mesh
ops: a ``scan`` along the grid's y axis for the global prefix integral and
an ``allreduce`` of the interior sums for the mean.

``step_fn`` advances a state through the plain PyTorch step
(``_step_local``) or, on the 1x1 grid, through the fused CUDA step
(``_sw_kernel.fused_step``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from ..ops import _collectives
from ..parallel.grid import ProcessGrid
from ..parallel.halo import halo_exchange
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
    *lead, m, n = interior.shape
    flat = interior.reshape(-1, m, n)
    return F.pad(flat, (1, 1, 1, 1), mode="replicate").reshape(
        *lead, m + 2, n + 2)


def _embed(old, interior):
    """``old`` with a new interior; its ghost ring is kept (the wall ghosts
    persist across steps, the exchange refreshes the others)."""
    out = old.clone()
    out[..., 1:-1, 1:-1] = interior
    return out


def _grid_shape(grid):
    if grid is None:
        return (1, 1)
    if isinstance(grid, ProcessGrid):
        return grid.shape
    return tuple(int(g) for g in grid)


def state_from_numpy(arrays, device, grid=None) -> SWState:
    """A state from six arrays in the JAX package's stacked-block layout
    ``(gy·(nyl+2), gx·(nxl+2))``, such as the JAX solver's state converted
    with ``np.asarray``.  ``grid``: a ``ProcessGrid`` or ``(gy, gx)``
    (default 1x1, whose layout is the block itself)."""
    dev = resolve_device(device)
    gy, gx = _grid_shape(grid)
    out = []
    for a in arrays:
        a = np.array(a, dtype=np.float32)
        if (gy, gx) != (1, 1):
            rows, cols = a.shape
            if rows % gy or cols % gx:
                raise ValueError(
                    f"an array of shape {a.shape} is not stacked blocks of "
                    f"grid ({gy}, {gx})")
            a = np.ascontiguousarray(
                a.reshape(gy, rows // gy, gx, cols // gx).transpose(0, 2, 1, 3))
        out.append(torch.from_numpy(a).to(dev))
    return SWState(*out)


def state_to_numpy(state: SWState) -> SWState:
    """The state as six numpy arrays in the JAX package's stacked-block
    layout, for handing to the JAX solver."""
    out = []
    for f in state:
        a = f.detach().cpu().numpy()
        if a.ndim == 4:
            gy, gx, rows, cols = a.shape
            a = np.ascontiguousarray(
                a.transpose(0, 2, 1, 3).reshape(gy * rows, gx * cols))
        out.append(a)
    return SWState(*out)


class ShallowWater:
    """Shallow-water solver over a 2-D process grid.

    ``global_shape = (ny, nx)`` is the physical (unpadded) domain; each rank
    owns a ``(ny/gy + 2, nx/gx + 2)`` halo-padded block.  ``grid``: a
    ``ProcessGrid``, a ``(gy, gx)`` shape, or ``None`` for the single block.
    ``device`` defaults to the grid's, else ``cuda:0``; pass
    ``device="cpu"`` for the CPU.  A domain the grid does not divide raises
    ``ValueError``; more than one device raises ``NotImplementedError``.
    """

    def __init__(self, global_shape, params: Optional[SWParams] = None, *,
                 grid=None, device=None):
        if isinstance(grid, ProcessGrid):
            if device is not None and resolve_device(device) != grid.device:
                raise ValueError(
                    f"device {device} differs from the grid's {grid.device}")
        else:
            grid = ProcessGrid(_grid_shape(grid), device=device)
        if grid.ndim != 2:
            raise ValueError(f"the solver needs a 2-D grid, got {grid.shape}")
        self.grid = grid
        self.device = grid.device
        self.ny, self.nx = (int(n) for n in global_shape)
        if self.ny < 1 or self.nx < 1:
            raise ValueError(f"empty domain {tuple(global_shape)}")
        gy, gx = grid.shape
        if self.ny % gy or self.nx % gx:
            raise ValueError(
                f"domain {tuple(global_shape)} not divisible by grid "
                f"{grid.shape}")
        self.ny_loc = self.ny // gy
        self.nx_loc = self.nx // gx
        self.params = params or SWParams(dx=5e3, dy=5e3)
        self.block_shape = (self.ny_loc + 2, self.nx_loc + 2)
        self.single = grid.shape == (1, 1)
        # the fields' shape: the block, behind the grid's axes unless 1x1
        self.state_shape = (self.block_shape if self.single
                            else grid.shape + self.block_shape)
        self._coords = None
        self.exchanges = 0  # calls of _exchange, read by the example's --json

    # -- layout ----------------------------------------------------------------
    def _ranked(self, f):
        """A field (or a field-shaped tensor) with the grid's axes leading."""
        return f.reshape(self.grid.shape + tuple(f.shape[-2:]))

    def _unranked(self, f):
        """The inverse of ``_ranked``: the state's layout."""
        return f if not self.single else f.reshape(f.shape[-2:])

    # -- coordinate fields -----------------------------------------------------
    def _local_coords(self):
        """Per rank, the halo-inclusive y and x coordinates of its block,
        each of shape ``(gy, gx, nyl+2, nxl+2)``."""
        if self._coords is None:
            p = self.params
            gy, gx = self.grid.shape
            iy = torch.arange(gy, device=self.device)
            ix = torch.arange(gx, device=self.device)
            jy = (torch.arange(-1, self.ny_loc + 1, device=self.device)[None]
                  + iy[:, None] * self.ny_loc)
            jx = (torch.arange(-1, self.nx_loc + 1, device=self.device)[None]
                  + ix[:, None] * self.nx_loc)
            y = jy.to(torch.float32) * p.dy
            x = jx.to(torch.float32) * p.dx
            shape = self.grid.shape + self.block_shape
            self._coords = (y[:, None, :, None].expand(shape),
                            x[None, :, None, :].expand(shape))
        return self._coords

    @property
    def _yy(self):
        return self._unranked(self._local_coords()[0])

    def _coriolis(self, yy):
        p = self.params
        return p.coriolis_f + yy * p.coriolis_beta

    # -- boundary handling -----------------------------------------------------
    def _exchange(self, fields, kinds):
        """Batched halo exchange plus the physical wall conditions.

        ``kinds``: each field's C-grid location, "h" | "u" | "v": v fields
        get the no-normal-flow wall at the north boundary (the ranks of the
        last grid row), u fields a wall at the east (the last grid column)
        when x is not periodic.
        """
        p = self.params
        self.exchanges += 1
        out = halo_exchange(
            tuple(self._ranked(f) for f in fields), self.grid, halo=1,
            periodic=(False, p.periodic_x),
        )
        result = []
        for f, kind in zip(out, kinds):
            if kind == "v":
                f[-1, :, -2, :] = 0.0
            elif kind == "u" and not p.periodic_x:
                f[:, -1, :, -2] = 0.0
            result.append(self._unranked(f))
        return result

    # -- initial conditions ----------------------------------------------------
    def init(self) -> SWState:
        """The initial state on the model's device: the geostrophic jet of
        the reference setup, computed with the mesh ops (the JAX solver's
        ``_initial_local``)."""
        p = self.params
        yy, xx = self._local_coords()
        ly = self.ny * p.dy
        lx = self.nx * p.dx

        u0 = 10.0 * torch.exp(-((yy - 0.5 * ly) ** 2) / (0.02 * lx) ** 2)
        v0 = torch.zeros_like(u0)

        # h in geostrophic balance: h(y) = -(1/g)∫ f·u dy, a global prefix
        # integral along y: a local cumsum plus the exclusive cross-rank
        # prefix of the column totals
        integrand = -p.dy * u0 * self._coriolis(yy) / p.gravity
        body = integrand[..., 1:-1, 1:-1]  # interior rows only
        local_cum = torch.cumsum(body, dim=-2)
        col_total = local_cum[..., -1, :].contiguous()
        incl = ops.scan(col_total, op=ops.SUM, comm=self.grid.axis_comm(0))
        offset = incl - col_total
        h_int = local_cum + offset[..., None, :]

        # center around the resting depth (global mean over the interior)
        total = ops.allreduce(h_int.sum(dim=(-2, -1)), op=ops.SUM,
                              comm=self.grid.comm)
        h_int = h_int - total[..., None, None] / float(self.ny * self.nx)

        h_int = (
            p.depth
            + h_int
            + 0.2
            * torch.sin(_C(xx) / lx * 10 * math.pi)
            * torch.cos(_C(yy) / ly * 8 * math.pi)
        )

        # edge pad: the wall ghosts continue the boundary value, the
        # interior ghosts are replaced by the exchange
        h0 = _edge_pad(h_int)
        h0, u0, v0 = self._exchange(
            (self._unranked(h0), self._unranked(u0.contiguous()),
             self._unranked(v0)), ("h", "u", "v"))
        zero = torch.zeros(self.state_shape, dtype=torch.float32,
                           device=self.device)
        return SWState(h0, u0, v0, zero, zero.clone(), zero.clone())

    # -- dynamics --------------------------------------------------------------
    def _step_local(self, state: SWState, first: bool) -> SWState:
        """One plain step; the oracle the fused kernel is held against."""
        p = self.params
        dt = p.dt
        dx, dy, g = p.dx, p.dy, p.gravity
        h, u, v, dh, du, dv = state

        (hc,) = self._exchange((_edge_pad(_C(h)),), ("h",))

        fe = _pad(0.5 * (_C(hc) + _E(hc)) * _C(u))
        fn = _pad(0.5 * (_C(hc) + _N(hc)) * _C(v))
        yy = self._yy
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

    # -- public entry points ---------------------------------------------------
    def step_fn(self, n_steps: int, first: bool = False, impl: str = "auto",
                fuse: int = 3, tile=None):
        """A function advancing a state ``n_steps`` steps.

        ``impl``: "plain" runs ``_step_local`` with the plain halo (the hop's
        plain version, even on the card: the oracle of ``chip_smoke.py``);
        "kernel" runs on the CUDA kernels and raises on a CPU state; "auto"
        picks the kernels for a CUDA state and the plain path for a CPU
        state.  There is no fallback.

        On the 1x1 grid the kernel path is the fused step
        (``_sw_kernel.fused_step``): ``first=True`` starts with one Euler
        step (fuse=1), then come whole calls of ``fuse`` steps each and
        single steps for the remainder.  The kernel writes into two state
        buffers that the function owns and alternates between, so after the
        first call it allocates nothing.  The state it returns is one of
        those buffers and is overwritten by its next call unless passed back
        in.  ``tile`` is the kernel's ``(rows, cols)`` output tile.

        On a decomposed grid the kernel path is ``_step_local`` with its
        halo exchanges on the hop kernel (the JAX package's fused step is
        single-block only); ``fuse`` and ``tile`` do not apply.
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

        def fused(state):
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
            if impl == "plain":
                with _collectives.use_plain():
                    return plain(state)
            if not state.h.is_cuda:
                if impl == "kernel":
                    raise ValueError(
                        "impl='kernel' needs a CUDA state; the state is on "
                        f"{state.h.device}"
                    )
                return plain(state)
            return fused(state) if self.single else plain(state)

        return run

    def interior(self, field) -> np.ndarray:
        """The physical ``(ny, nx)`` field as a numpy array, reassembled
        from the ranks' blocks."""
        f = self._ranked(field)[..., 1:-1, 1:-1].detach().cpu().numpy()
        gy, gx, m, n = f.shape
        return np.ascontiguousarray(
            f.transpose(0, 2, 1, 3).reshape(gy * m, gx * n))

    def total_mass(self, state: SWState) -> float:
        h = self.interior(state.h)
        return float(np.sum(h, dtype=np.float64) * self.params.dx
                     * self.params.dy)
