"""World-tier shallow water: one process per rank, the reference's shape.

The counterpart of ``mpi4jax_tpu/models/shallow_water_world.py``.  The
mesh-tier solver (``models/shallow_water.py``) holds every rank's block as
a leading dimension of one tensor; this one is the shape the reference
runs with ``mpirun -n N``: a program per rank, on its own block, with the
halo exchange as explicit point-to-point over the world tier's transport.

The physics is inherited from :class:`~.shallow_water.ShallowWater`; only
the substrate is swapped:

- the rank grid is row-major (``rank = iy * gx + ix``, ``iy`` south to
  north) and each rank's coordinates are plain ints;
- the halo exchange is one ``neighbor_exchange`` per direction (both
  strips of every field in one stacked message, tag ``60 + 2 * dim``);
  wall sides keep their ghosts, a rank that is its own neighbour (a
  periodic ring of one) rotates locally;
- the initial condition's ``scan`` along the grid's columns (on
  ``comm.split(color=ix, key=iy)``) and its ``allreduce`` of the mass
  (``algo=None``) go through the same ``ops`` calls as on the mesh tier,
  here routed to the world tier;
- ``gather_global`` reassembles the full field on rank 0 with a world
  ``gather``.

Every step is the plain ``_step_local`` on the rank's block, on
``comm.device``: the fused step kernel is a single-block mesh path, so
``step_fn(impl="kernel")`` raises, as the JAX world solver refuses Pallas.

Launch (``benchmarks/sw_world.py`` wraps this)::

    python -m mpi4jax_tpu_torch.runtime.launch -n 4 \\
        -m mpi4jax_tpu_torch.benchmarks.sw_world -- --grid 2 2
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import ops
from .shallow_water import ShallowWater, SWParams, SWState


class _WorldGrid:
    """The grid surface the solver touches on the world tier."""

    def __init__(self, comm, shape, coords):
        self.comm = comm
        self.shape = shape
        self.coords = coords
        self._col_comm = None

    def axis_comm(self, dim: int):
        if dim != 0:
            raise ValueError("the world solver scans along y only")
        if self._col_comm is None:
            iy, ix = self.coords
            # the ranks of one column, ordered south to north by iy
            self._col_comm = self.comm.split(color=ix, key=iy)
        return self._col_comm


class WorldShallowWater(ShallowWater):
    """The solver on one rank of a ``(gy, gx)`` grid of world ranks.

    ``comm``: the world comm (or a sub-communicator) of ``gy * gx`` ranks;
    the state lives on ``comm.device``.  ``global_shape = (ny, nx)`` is the
    whole domain, which the grid must divide; each rank's fields are
    ``(ny/gy + 2, nx/gx + 2)``.
    """

    def __init__(self, comm, grid_shape, global_shape,
                 params: Optional[SWParams] = None):
        gy, gx = (int(g) for g in grid_shape)
        if comm.size() != gy * gx:
            raise ValueError(f"grid {tuple(grid_shape)} needs {gy * gx} "
                             f"ranks, the comm has {comm.size()}")
        self.ny, self.nx = (int(n) for n in global_shape)
        if self.ny % gy or self.nx % gx:
            raise ValueError(f"domain {tuple(global_shape)} not divisible "
                             f"by grid {tuple(grid_shape)}")
        self.comm = comm
        self.device = comm.device
        self.rank = comm.rank()
        self.iy, self.ix = divmod(self.rank, gx)
        self.gy, self.gx = gy, gx
        self.ny_loc = self.ny // gy
        self.nx_loc = self.nx // gx
        self.params = params or SWParams(dx=5e3, dy=5e3)
        self.block_shape = (self.ny_loc + 2, self.nx_loc + 2)
        self.single = False  # no fused kernel: every step is the plain one
        self.state_shape = self.block_shape
        self.grid = _WorldGrid(comm, (gy, gx), (self.iy, self.ix))
        self._coords = None
        self.exchanges = 0  # calls of _exchange

    # -- substrate ---------------------------------------------------------
    def _unranked(self, f):
        return f

    def _local_coords(self):
        """This rank's halo-inclusive y and x coordinates, each
        ``(nyl+2, nxl+2)``."""
        if self._coords is None:
            p = self.params
            jy = (torch.arange(-1, self.ny_loc + 1, device=self.device)
                  + self.iy * self.ny_loc)
            jx = (torch.arange(-1, self.nx_loc + 1, device=self.device)
                  + self.ix * self.nx_loc)
            y = jy.to(torch.float32) * p.dy
            x = jx.to(torch.float32) * p.dx
            self._coords = (y[:, None].expand(self.block_shape),
                            x[None, :].expand(self.block_shape))
        return self._coords

    def _neighbor(self, diy, dix):
        """Rank of the (diy, dix) grid neighbour, or None (a wall)."""
        iy, ix = self.iy + diy, self.ix + dix
        if not 0 <= iy < self.gy:
            return None
        if not 0 <= ix < self.gx:
            if not self.params.periodic_x:
                return None
            ix %= self.gx
        return iy * self.gx + ix

    def _dir_exchange(self, stack, dim, hi_neighbor, lo_neighbor):
        """Fill the ghost strips of the field stack ``(nfields, m+2, n+2)``
        along array dim ``dim``, in place: the interior strips go to the
        neighbours, what arrives fills the ghosts, and a wall side keeps
        its ghost (the boundary condition).  Both directions ride one
        ``neighbor_exchange``: pairing them per neighbour deadlocks on a
        periodic ring of three or more ranks, and two shifts cost a second
        blocking wait (``mpi4jax_tpu/models/shallow_water_world.py:107-138``
        there)."""
        ax = dim + 1
        extent = stack.shape[ax]
        lo_int = stack.narrow(ax, 1, 1)
        hi_int = stack.narrow(ax, extent - 2, 1)
        if hi_neighbor is None and lo_neighbor is None:
            return stack  # both walls: nothing to exchange
        if hi_neighbor == self.rank and lo_neighbor == self.rank:
            # self-wrap: the high ghost is the low interior strip and the
            # other way round
            from_above, from_below = lo_int, hi_int
        else:
            from_below, from_above = ops.neighbor_exchange(
                lo_int, hi_int, lo=lo_neighbor, hi=hi_neighbor,
                comm=self.comm, tag=60 + 2 * dim)
            if lo_neighbor is None:
                from_below = None  # wall: keep the ghost
            if hi_neighbor is None:
                from_above = None
        if from_above is not None:
            stack.narrow(ax, extent - 1, 1).copy_(from_above)
        if from_below is not None:
            stack.narrow(ax, 0, 1).copy_(from_below)
        return stack

    def _exchange(self, fields, kinds):
        """The halo exchange of ``fields`` (one message per direction for
        all of them) and the walls: v at the north boundary, u at the east
        one when x is not periodic."""
        self.exchanges += 1
        stack = torch.stack(list(fields))
        stack = self._dir_exchange(stack, 0, self._neighbor(+1, 0),
                                   self._neighbor(-1, 0))
        stack = self._dir_exchange(stack, 1, self._neighbor(0, +1),
                                   self._neighbor(0, -1))
        at_north = self.iy == self.gy - 1
        at_east = self.ix == self.gx - 1
        result = []
        for f, kind in zip(stack.unbind(0), kinds):
            if kind == "v" and at_north:
                f[-2, :] = 0.0
            elif kind == "u" and not self.params.periodic_x and at_east:
                f[:, -2] = 0.0
            result.append(f)
        return result

    # -- entry points --------------------------------------------------------
    def step_fn(self, n_steps: int, first: bool = False, impl: str = "auto",
                fuse: int = 3, tile=None):
        """A function advancing this rank's state ``n_steps`` plain steps
        (``first=True``: an Euler step first).  ``impl`` "auto" or "plain";
        "kernel" raises ``ValueError``: the fused step kernel is a
        single-block mesh path."""
        if impl not in ("auto", "plain"):
            raise ValueError(
                "the world-tier solver runs the plain step on each rank "
                "(the fused step kernel is a single-block mesh path)")

        def run(state):
            s = SWState(*state)
            remaining = n_steps
            if first and remaining > 0:
                s = self._step_local(s, True)
                remaining -= 1
            for _ in range(remaining):
                s = self._step_local(s, False)
            return s

        return run

    def interior(self, field) -> torch.Tensor:
        """This rank's ``(nyl, nxl)`` block without its ghosts."""
        return field[1:-1, 1:-1]

    def total_mass(self, state: SWState) -> float:
        """The whole domain's mass: an f64 allreduce of the ranks' sums."""
        local = self.interior(state.h).to(torch.float64).sum()
        total = ops.allreduce(local, op=ops.SUM, comm=self.comm)
        return float(total) * self.params.dx * self.params.dy

    def gather_global(self, field) -> Optional[np.ndarray]:
        """The whole ``(ny, nx)`` field on rank 0 (None elsewhere): a world
        gather of the blocks, reassembled."""
        rows = ops.gather(self.interior(field).contiguous(), root=0,
                          comm=self.comm)
        if self.rank != 0:
            return None
        blocks = rows.cpu().numpy().reshape(self.gy, self.gx, self.ny_loc,
                                            self.nx_loc)
        return np.ascontiguousarray(
            blocks.transpose(0, 2, 1, 3).reshape(self.ny, self.nx))
