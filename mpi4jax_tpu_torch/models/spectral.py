"""Distributed 3-D FFT by slab decomposition and alltoall transposes.

The counterpart of ``mpi4jax_tpu/models/spectral.py``.  A field ``(X, Y,
Z)`` is slab-decomposed over X: on a communicator of n ranks it is the
rank-stacked ``(*lead, X/n, Y, Z)`` (``lead`` the mesh's rank dimensions,
``(n,)`` on a 1-D mesh).  ``fft3`` returns the spectrum slab-decomposed over
Y, ``(*lead, X, Y/n, Z)``; ``ifft3`` goes back.  The local FFTs are
``torch.fft`` (the JAX package leaves them to XLA's ``jnp.fft``), and each
global transpose is one call of the mesh ``alltoall``, which is one launch
of the alltoall kernel on the card.

``poisson_solve`` solves ``∇²u = f`` with periodic boundaries, spectrally:
two alltoalls per solve, one in ``fft3`` and one in ``ifft3``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.alltoall import alltoall
from ..utils import validation as _validation


def _transpose_x_to_y(x, comm):
    """``(*lead, X/n, Y, Z)`` X-slabs to ``(*lead, X, Y/n, Z)`` Y-slabs,
    one alltoall."""
    size = comm.size()
    if size == 1:  # one slab is the whole field
        return x
    lead = comm.layout_shape
    xl, y, z = x.shape[len(lead):]
    if y % size:
        raise ValueError(f"Y ({y}) must be divisible by the comm size {size}")
    yl = y // size
    # destination-major leading local axis for the alltoall: one copy, which
    # a later kernel could fold into its addressing
    t = x.reshape(*lead, xl, size, yl, z).transpose(len(lead), len(lead) + 1)
    t = alltoall(t.contiguous(), comm=comm)
    # rows are source ranks = X blocks, in rank order: concatenate along X
    return t.reshape(*lead, size * xl, yl, z)


def _transpose_y_to_x(x, comm):
    """The inverse of :func:`_transpose_x_to_y`."""
    size = comm.size()
    if size == 1:
        return x
    lead = comm.layout_shape
    xg, yl, z = x.shape[len(lead):]
    if xg % size:
        raise ValueError(f"X ({xg}) must be divisible by the comm size {size}")
    xl = xg // size
    # torch.fft leaves the transformed X innermost in memory, so this is one
    # strided copy, as the pre-transpose of _transpose_x_to_y is
    t = alltoall(x.reshape(*lead, size, xl, yl, z).contiguous(), comm=comm)
    # rows are source ranks = Y blocks: concatenate along Y
    return t.transpose(len(lead), len(lead) + 1).reshape(
        *lead, xl, size * yl, z)


def _complex(x):
    return x if x.dtype == torch.complex128 else x.to(torch.complex64)


def fft3(x, *, comm=None):
    """3-D FFT of an X-slab field ``(*lead, X/n, Y, Z)``, real or complex:
    the complex64 (complex128 for complex128 input) spectrum
    ``(*lead, X, Y/n, Z)``, Y-slabs."""
    comm = _validation.resolve_comm(comm, mesh_only="the slab FFT")
    x = torch.fft.fftn(_complex(x), dim=(-2, -1))  # local Y, Z transforms
    x = _transpose_x_to_y(x, comm)                   # one alltoall
    return torch.fft.fft(x, dim=len(comm.layout))    # the now-local X


def ifft3(x, *, comm=None):
    """The inverse of :func:`fft3`: Y-slab spectrum to X-slab field."""
    comm = _validation.resolve_comm(comm, mesh_only="the slab FFT")
    x = torch.fft.ifft(x, dim=len(comm.layout))
    x = _transpose_y_to_x(x, comm)
    return torch.fft.ifftn(x, dim=(-2, -1))


def wavenumbers(n: int, d: float = 1.0, *, device=None):
    """``2π · fftfreq(n, d)`` in float64, made on ``device`` (no copy from
    the host, which would wait for the card)."""
    return 2 * np.pi * torch.fft.fftfreq(n, d=d, dtype=torch.float64,
                                         device=device)


def poisson_solve(f, *, comm=None, shape, lengths=(2 * np.pi,) * 3):
    """Solve ``∇²u = f`` with periodic boundaries, spectrally.

    ``f``: the real X-slab field ``(*lead, X/n, Y, Z)``.  Returns the
    zero-mean solution, float32, with the same layout.
    """
    comm = _validation.resolve_comm(comm, mesh_only="the slab FFT")
    nx, ny, nz = shape
    lx, ly, lz = lengths
    size = comm.size()
    dev = f.device

    spec = fft3(f, comm=comm)  # (*lead, X, Y/n, Z), Y-slabs

    def k(n, length):  # float32, as jnp.asarray makes the float64 numbers
        return wavenumbers(n, length / n, device=dev).to(torch.float32)

    kx = k(nx, lx)
    ky_full = k(ny, ly)
    yl = ny // size
    # each rank's Y slab of ky, stacked over the mesh: (*lead, Y/n)
    rows = comm.rank(dev)[..., None] * yl + torch.arange(yl, device=dev)
    ky = ky_full[rows]
    kz = k(nz, lz)

    k2 = (kx[:, None, None] ** 2
          + ky[..., None, :, None] ** 2
          + kz[None, None, :] ** 2)
    inv = torch.where(k2 > 0, -1.0 / torch.clamp(k2, min=1e-30),
                      torch.zeros((), dtype=k2.dtype, device=dev))
    u_spec = spec * inv  # the zero mode dropped: a zero-mean solution
    return ifft3(u_spec, comm=comm).real
