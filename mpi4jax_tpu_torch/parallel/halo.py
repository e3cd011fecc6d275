"""Halo (ghost-cell) exchange for domain-decomposed stencil codes.

The counterpart of ``mpi4jax_tpu/parallel/halo.py``, with every rule of it:

- the fields are stacked into one exchange per axis direction;
- the axes are exchanged in order, axis 0 first and then axis 1 over the
  full extent including the new ghost rows, so the corners come out right;
- an axis of one rank is a local wrap, or nothing when it is not periodic;
- an axis of more ranks moves both strips in one ``ring_shift2``, which on
  the card is one launch of the hop kernel;
- at a non-periodic boundary the existing ghosts are kept (``ring_shift2``
  delivers wrapped values there, which are masked).

Layout: a field is ``(*grid.shape, *local)``, the grid's rank axes leading
(``parallel/mesh.py``); a local field of interior shape ``(m, n)`` is
stored as ``(m + 2*halo, n + 2*halo)``.  Fields are not modified: the
results are new tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import _collectives
from .grid import ProcessGrid


def _axis_exchange(f, dim: int, gdim: int, grid: ProcessGrid, halo: int,
                   periodic: bool):
    """Fill, in place, the two ghost strips of ``f`` along tensor dimension
    ``dim``, from the neighbours along grid dimension ``gdim``."""
    n = grid.shape[gdim]
    extent = f.shape[dim]
    lo_interior = f.narrow(dim, halo, halo)
    hi_interior = f.narrow(dim, extent - 2 * halo, halo)

    if n == 1:
        if not periodic:
            return
        # self-neighbour: wrap our own interior strips into our ghosts
        from_above, from_below = hi_interior.clone(), lo_interior.clone()
    else:
        # one launch: hi strips move to the next rank, lo strips to the
        # previous one
        from_above, from_below = _collectives.ring_shift2(
            hi_interior.contiguous(), lo_interior.contiguous(),
            grid.axis_comm(gdim))

    lo_ghost = f.narrow(dim, 0, halo)
    hi_ghost = f.narrow(dim, extent - halo, halo)
    if not periodic:
        # at the physical boundary keep the existing ghost values (the
        # solver's boundary condition), not the wrapped ones
        idx = grid.coords()[gdim].reshape(
            grid.shape + (1,) * (f.dim() - grid.ndim))
        from_above = torch.where(idx > 0, from_above, lo_ghost)
        from_below = torch.where(idx < n - 1, from_below, hi_ghost)
    lo_ghost.copy_(from_above)
    hi_ghost.copy_(from_below)


def halo_exchange(
    f,
    grid: ProcessGrid,
    *,
    halo: int = 1,
    periodic: Sequence[bool] | bool = True,
    dims: Optional[Sequence[int]] = None,
):
    """Fill the ghost rings of ``f`` from the grid neighbours.

    Args:
        f: a field (or a tuple of fields, exchanged together) of shape
            ``(*grid.shape, *local)`` whose local dimensions ``dims`` carry
            ``halo``-wide ghost rings.
        grid: the :class:`ProcessGrid`.
        halo: ghost width.
        periodic: per-dimension wraparound flag (a bool broadcasts).
        dims: which local dimensions correspond to the grid's dimensions
            (default: 0..ndim-1).
    """
    single = not isinstance(f, (tuple, list))
    fields = (f,) if single else tuple(f)
    if isinstance(periodic, bool):
        periodic = (periodic,) * grid.ndim
    if dims is None:
        dims = tuple(range(grid.ndim))
    lead = grid.ndim
    for x in fields:
        if tuple(x.shape[:lead]) != grid.shape:
            raise ValueError(
                f"a field of shape {tuple(x.shape)} does not lead with the "
                f"grid's shape {grid.shape}")

    if all(s == 1 for s in grid.shape):
        # no direction communicates (single-block grid): update each
        # field's ghosts locally instead of stacking
        out = []
        for x in fields:
            x = x.clone()
            for gdim, (adim, per) in enumerate(zip(dims, periodic)):
                _axis_exchange(x, lead + adim, gdim, grid, halo, per)
            out.append(x)
        return out[0] if single else tuple(out)

    # one stacked exchange per direction for all fields; the field index
    # sits after the rank axes so that each rank's block stays contiguous
    stacked = torch.stack([x.to(fields[0].dtype) for x in fields], dim=lead)
    for gdim, (adim, per) in enumerate(zip(dims, periodic)):
        _axis_exchange(stacked, lead + 1 + adim, gdim, grid, halo, per)
    out = tuple(stacked.select(lead, i).to(fields[i].dtype)
                for i in range(len(fields)))
    return out[0] if single else out
