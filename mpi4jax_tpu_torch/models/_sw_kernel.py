"""The fused shallow-water step: wrapper around ``csrc/sw_step.cu``.

Counterpart of ``mpi4jax_tpu/models/_sw_pallas.py``: ``fuse`` whole steps
of the single-block, x-periodic solver in one kernel launch, with one read
and one write of the six state fields per launch.  The kernel takes the
``(ny+2, nx+2)`` arrays as they are; the TPU kernel's row and column
alignment padding has no counterpart on the card.

On a CUDA tensor ``fused_step`` launches the kernel on the current stream;
on a CPU tensor it runs ``fused_step_plain``, which applies the plain step
``fuse`` times.  Nothing falls back: a kernel that does not build or does
not launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

LAUNCHES = 0  # kernel launches since the last reset; read by chip_smoke.py

DEFAULT_TILE = (32, 32)  # output rows x columns of one thread block
HALO_PER_STEP = 4  # window cells per side per step: the stencil chain's depth
SMEM_ARRAYS = 11  # six fields plus five intermediates in shared memory
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use (sm_90)

_ARGTYPES = (
    [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 5
    + [ctypes.c_float] * 9
    + [ctypes.c_void_p]
)


def smem_bytes(tile, fuse: int) -> int:
    """Dynamic shared memory of one block: SMEM_ARRAYS window arrays."""
    halo = HALO_PER_STEP * fuse
    return SMEM_ARRAYS * (tile[0] + 2 * halo) * (tile[1] + 2 * halo) * 4


def _check(state, out, params, first, fuse, tile):
    if len(state) != 6:
        raise ValueError(f"a state has 6 fields, got {len(state)}")
    h = state[0]
    if h.dim() != 2 or h.shape[0] < 3 or h.shape[1] < 3:
        raise ValueError(f"fields must be (ny+2, nx+2), got {tuple(h.shape)}")
    for f in tuple(state) + (tuple(out) if out is not None else ()):
        if f.dtype != torch.float32:
            raise TypeError(f"fields must be float32, got {f.dtype}")
        if f.shape != h.shape:
            raise ValueError(f"field shape {tuple(f.shape)} != {tuple(h.shape)}")
        if f.device != h.device:
            raise ValueError(f"fields on {f.device} and {h.device}")
        if not f.is_contiguous():
            raise ValueError("fields must be contiguous")
    if first and fuse != 1:
        raise ValueError("the Euler bootstrap step requires fuse=1")
    if fuse < 1:
        raise ValueError(f"fuse must be >= 1, got {fuse}")
    if not params.periodic_x:
        raise ValueError("the fused step needs periodic_x=True")
    if out is not None:
        ins = {f.data_ptr() for f in state}
        if any(f.data_ptr() in ins for f in out):
            raise ValueError("out must not alias the input state")
    if smem_bytes(tile, fuse) > SMEM_LIMIT:
        raise ValueError(
            f"tile {tile} at fuse={fuse} needs {smem_bytes(tile, fuse)} B of "
            f"shared memory, more than {SMEM_LIMIT}"
        )


def fused_step_plain(state, params, *, first: bool, fuse: int = 1):
    """The plain version: the plain step applied ``fuse`` times."""
    from .shallow_water import ShallowWater, SWState

    nyp, nxp = state[0].shape
    model = ShallowWater((nyp - 2, nxp - 2), params, device=state[0].device)
    s = SWState(*state)
    for i in range(fuse):
        s = model._step_local(s, first and i == 0)
    return s


def fused_step(state, params, *, first: bool, fuse: int = 1, out=None,
               tile=None):
    """``fuse`` whole shallow-water steps of ``state`` in one kernel launch.

    ``state``: six contiguous f32 ``(ny+2, nx+2)`` tensors with valid ghost
    columns (the solver's invariant).  ``first=True`` is the Euler bootstrap
    (Adams–Bashforth with a=1, b=0) and needs ``fuse == 1``.  ``out``: six
    preallocated tensors that must not alias ``state``.  ``tile``: the
    ``(rows, cols)`` that one thread block writes (default 32x32).
    """
    global LAUNCHES
    from .shallow_water import SWState

    tile = tuple(tile) if tile is not None else DEFAULT_TILE
    _check(state, out, params, first, fuse, tile)
    if not state[0].is_cuda:
        result = fused_step_plain(state, params, first=first, fuse=fuse)
        if out is None:
            return result
        for o, r in zip(out, result):
            o.copy_(r)
        return SWState(*out)

    if out is None:
        out = SWState(*(torch.empty_like(f) for f in state))
    nyp, nxp = state[0].shape
    lib = _build.library("sw_step")
    fn = lib.sw_fused_step
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    p = params
    stream = torch.cuda.current_stream(state[0].device).cuda_stream
    with torch.cuda.device(state[0].device):
        err = fn(
            *(f.data_ptr() for f in state),
            *(f.data_ptr() for f in out),
            nyp, nxp, fuse, tile[0], tile[1],
            p.dx, p.dy, p.gravity, p.viscosity, p.dt,
            p.coriolis_f, p.coriolis_beta,
            1.0 if first else p.ab_a,
            0.0 if first else p.ab_b,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"sw_fused_step failed: {_build.error_string(lib, err)}")
    LAUNCHES += 1
    return SWState(*out)
