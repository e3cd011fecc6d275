"""Cartesian process grids on one device.

The counterpart of ``mpi4jax_tpu/parallel/grid.py``: the grid is a mesh with
one named axis per dimension, and its tensors carry those axes as leading
dimensions (``parallel/mesh.py``).  ``axis_comm(d)`` is the row or column
communicator along dimension d.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .mesh import MeshComm


class ProcessGrid:
    """An N-D cartesian communicator.

    ``shape`` gives the number of ranks per dimension; ``axes`` names them
    (default ``grid0``, ``grid1``, ...).  ``device`` defaults to ``cuda:0``;
    a list of more than one device raises ``NotImplementedError``.
    """

    def __init__(self, shape: Sequence[int], axes: Optional[Sequence[str]] = None,
                 device=None):
        self.shape = tuple(int(s) for s in shape)
        ndim = len(self.shape)
        if axes is None:
            axes = tuple(f"grid{i}" for i in range(ndim))
        self.axes = tuple(axes)
        if len(self.axes) != ndim:
            raise ValueError("axes must match shape length")
        self.comm = MeshComm(self.axes, self.shape, device)
        self.device = self.comm.device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def coords(self) -> Tuple[torch.Tensor, ...]:
        """Each rank's grid coordinates: per dimension, an int64 tensor of
        the grid's shape."""
        return tuple(
            torch.arange(s, device=self.device).reshape(
                [s if i == d else 1 for i in range(self.ndim)]
            ).expand(self.shape)
            for d, s in enumerate(self.shape)
        )

    def axis_comm(self, dim: int) -> MeshComm:
        """Sub-communicator along one grid dimension (row/col comms)."""
        return self.comm.sub(self.axes[dim])

    def __repr__(self):
        return f"ProcessGrid(shape={self.shape}, axes={self.axes})"
