"""Communicators and the SPMD entry point of the mesh tier.

The counterpart of ``mpi4jax_tpu/parallel/mesh.py``.  There a communicator
is a set of named axes of a device mesh, and ``shard_map`` runs a per-rank
function.  Here every rank lives on one device and the rank axes are written
out as leading dimensions:

- a tensor on a ``MeshComm`` whose mesh has axes of sizes ``(s0, s1, ...)``
  has shape ``(s0, s1, ..., *local)``; rank r's block is the contiguous
  slice ``x[i0, i1, ...]``, where ``(i0, i1, ...)`` are r's row-major
  coordinates, as ``Mesh`` flattens them;
- a collective over some of those axes acts along them and is batched over
  the others.

A ``MeshComm`` knows its own axes and the mesh's axes (its ``layout``): a
sub-communicator of a 2-D grid still sees tensors with both leading
dimensions.  ``spmd`` pushes a comm as the ambient default and calls the
function once, on the rank-stacked tensors.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import torch

from ..utils.device import resolve_device


class CommBase:
    """Abstract communicator."""

    def rank(self):
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def __enter__(self):
        _push_comm(self)
        return self

    def __exit__(self, *exc):
        _pop_comm(self)
        return False


class MeshComm(CommBase):
    """Communicator over one or more axes of a mesh on one device.

    ``axes``: an axis name or a tuple of names; with several the rank is the
    row-major flattening of the per-axis indices.  ``shape``: the size of
    each axis (an int for one axis).  ``device``: where the rank-stacked
    tensors live (default ``cuda:0``).  ``layout``: the ``(name, size)``
    pairs of every leading rank dimension of the tensors, in order; by
    default the comm's own axes.

    Hashable and comparable by its axes, like the JAX package's comm.
    """

    def __init__(self, axes="mpi", shape=None, device=None, *, layout=None):
        if isinstance(axes, str):
            axes = (axes,)
        self.axes: tuple = tuple(axes)
        if layout is None:
            if shape is None:
                raise ValueError("MeshComm needs the size of each axis")
            if isinstance(shape, int):
                shape = (shape,)
            shape = tuple(int(s) for s in shape)
            if len(shape) != len(self.axes):
                raise ValueError(
                    f"axes {self.axes} and shape {shape} differ in length")
            layout = tuple(zip(self.axes, shape))
        self.layout: tuple = tuple((str(a), int(s)) for a, s in layout)
        names = [a for a, _ in self.layout]
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis in layout {self.layout}")
        for a in self.axes:
            if a not in names:
                raise ValueError(f"axis {a!r} not in layout {self.layout}")
        if any(s < 1 for _, s in self.layout):
            raise ValueError(f"axis sizes must be >= 1: {self.layout}")
        sizes = dict(self.layout)
        if shape is not None:
            own = (shape,) if isinstance(shape, int) else tuple(shape)
            if tuple(sizes[a] for a in self.axes) != tuple(own):
                raise ValueError(
                    f"shape {own} disagrees with layout {self.layout}")
        self.shape: tuple = tuple(sizes[a] for a in self.axes)
        self.device = resolve_device(device)
        # the sizes of the leading rank dimensions, the positions of the
        # comm's axes among them, and the number of ranks of the mesh
        self.layout_shape: tuple = tuple(s for _, s in self.layout)
        self.dims: tuple = tuple(names.index(a) for a in self.axes)
        self.nranks: int = math.prod(self.layout_shape)
        self._ranks = tuple(
            _ravel([_unravel(f, self.layout_shape)[d] for d in self.dims],
                   self.shape)
            for f in range(self.nranks))
        # hop and alltoall tables of the collectives, rank tensors,
        # sub-communicators
        self.tables: dict = {}

    # -- identity -----------------------------------------------------------
    def __hash__(self):
        return hash(("mpi4jax_tpu_torch.MeshComm", self.axes))

    def __eq__(self, other):
        return isinstance(other, MeshComm) and other.axes == self.axes

    def __repr__(self):
        return f"MeshComm(axis={self.axes!r}, shape={self.shape})"

    # -- topology -----------------------------------------------------------
    def size(self) -> int:
        return math.prod(self.shape)

    def rank(self, device=None) -> torch.Tensor:
        """The rank along this comm's axes, as an int64 tensor of shape
        ``layout_shape`` on ``device`` (default the comm's): element
        ``[i0, i1, ...]`` is that rank's.  Made once per device and shared:
        callers must not write to it."""
        dev = self.device if device is None else torch.device(device)
        key = ("rank", str(dev))
        r = self.tables.get(key)
        if r is None:
            r = torch.tensor(self.ranks(), dtype=torch.int64,
                             device=dev).reshape(self.layout_shape)
            self.tables[key] = r
        return r

    def ranks(self) -> tuple:
        """Per mesh rank (row-major over the layout), its rank on this
        comm, as Python ints."""
        return self._ranks

    def peer(self, f: int, c: int) -> int:
        """The mesh rank that has comm rank ``c`` in mesh rank ``f``'s
        group (the same coordinates on every other axis)."""
        coords = _unravel(f, self.layout_shape)
        for d, i in zip(self.dims, _unravel(c, self.shape)):
            coords[d] = i
        return _ravel(coords, self.layout_shape)

    def sub(self, axis) -> "MeshComm":
        """Sub-communicator over a subset of this comm's axes, made once per
        axes and cached on this comm, so that its hop tables and launch
        plans are made once too (the halo asks for it at every
        exchange)."""
        if isinstance(axis, str):
            axis = (axis,)
        key = ("sub", tuple(axis))
        comm = self.tables.get(key)
        if comm is None:
            for a in axis:
                if a not in self.axes:
                    raise ValueError(f"axis {a!r} not part of {self!r}")
            comm = MeshComm(tuple(axis), device=self.device,
                            layout=self.layout)
            self.tables[key] = comm
        return comm


def _unravel(f: int, shape) -> list:
    coords = []
    for s in reversed(shape):
        coords.append(f % s)
        f //= s
    return coords[::-1]


def _ravel(coords, shape) -> int:
    f = 0
    for i, s in zip(coords, shape):
        f = f * s + int(i)
    return f


_DEFAULT_AXIS = "mpi"


class _CommStack(threading.local):
    def __init__(self):
        self.stack = []


_comm_stack = _CommStack()


def _push_comm(comm):
    _comm_stack.stack.append(comm)


def _pop_comm(comm):
    top = _comm_stack.stack.pop()
    if top is not comm:  # pragma: no cover - misuse guard
        raise RuntimeError("communicator context stack corrupted")


def current_comm() -> Optional[CommBase]:
    return _comm_stack.stack[-1] if _comm_stack.stack else None


def get_default_comm() -> CommBase:
    """The innermost active comm, else the process's world comm when it
    was launched as a rank of a world job.

    Outside ``spmd``, a ``with comm:`` block or a world job there is no
    default: the JAX package's default mesh over every device has no
    counterpart on one card.
    """
    comm = current_comm()
    if comm is not None:
        return comm
    from ..runtime import transport

    if transport.in_world():
        return transport.get_world_comm()
    raise RuntimeError(
        "no communicator: pass comm=, or call inside spmd(...), a "
        "'with comm:' block or a world job")


def make_mesh(n: Optional[int] = None, axis: str = _DEFAULT_AXIS,
              device=None) -> MeshComm:
    """A 1-D mesh of ``n`` ranks on one device, as its communicator.

    ``n=None`` means one rank per device, as the JAX package's default of
    all devices does; the port has one device.  ``device`` defaults to
    ``cuda:0``; a list of more than one device raises
    ``NotImplementedError``.
    """
    dev = resolve_device(device)
    if n is None:
        n = 1
    n = int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    return MeshComm((axis,), (n,), dev)


def spmd(fn=None, *, comm: Optional[MeshComm] = None):
    """Run ``fn`` over the ranks of ``comm`` (the ``mpirun`` of the mesh
    tier).

    ``fn`` is called once, on the rank-stacked tensors (each with the
    comm's leading rank dimensions), with ``comm`` as the ambient default,
    so op calls inside need no ``comm=``.  ``comm`` defaults to
    ``make_mesh()``.

        comm = make_mesh(4)

        @spmd(comm=comm)
        def step(x):          # x: (4, *local)
            return allreduce(x, op=SUM)
    """

    def wrap(f):
        def call(*args, **kwargs):
            c = comm if comm is not None else make_mesh()
            with c:
                return f(*args, **kwargs)

        call.__name__ = getattr(f, "__name__", "spmd_fn")
        return call

    if fn is not None:
        return wrap(fn)
    return wrap
