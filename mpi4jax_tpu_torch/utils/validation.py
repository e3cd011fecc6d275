"""Argument validation for the public op functions.

The counterpart of ``mpi4jax_tpu/utils/validation.py`` and the comm
resolution of ``mpi4jax_tpu/ops/_dispatch.py``, for the ported ops: every
op checks its arguments eagerly and names itself, the comm and the tensor in
the message.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import dtypes as _dtypes


class ValidationError(TypeError):
    pass


def _describe(value: Any) -> str:
    return f"{type(value).__module__}.{type(value).__qualname__}"


def check_static_int(name: str, value: Any):
    """``value`` as an int; bools, tensors and other types raise."""
    if isinstance(value, (bool, np.bool_)):
        raise ValidationError(f"{name} must be an integer, got bool")
    if not isinstance(value, (int, np.integer)):
        raise ValidationError(
            f"{name} must be an integer, got {_describe(value)}")
    return int(value)


def op_context(op_name: str, comm=None, x=None) -> str:
    """`` [op, mesh axes (...) or rank r/n, dtype ..., shape (...)]``."""
    bits = [op_name]
    if comm is not None:
        bits.append(f"mesh axes {comm.axes!r}" if hasattr(comm, "axes")
                    else f"rank {comm.rank()}/{comm.size()}")
    if isinstance(x, torch.Tensor):
        bits.append(f"dtype {_dtypes.dtype_name(x.dtype)}")
        bits.append(f"shape {tuple(x.shape)}")
    return " [" + ", ".join(bits) + "]"


def fail(msg: str, *, op: str, comm=None, x=None, exc=None):
    """Raise a ``ValidationError`` (or ``exc``) with the op's context."""
    raise (exc or ValidationError)(msg + op_context(op, comm, x))


def resolve_comm(comm, *, mesh_only: str = None):
    """``comm``, or the ambient one: a ``MeshComm`` or a ``WorldComm``;
    anything else raises ``TypeError``.  ``mesh_only`` names a function
    that has no world-tier route: a ``WorldComm`` then raises
    ``NotImplementedError``."""
    from ..parallel.mesh import MeshComm, get_default_comm
    from ..runtime.transport import WorldComm

    if comm is None:
        comm = get_default_comm()
    if isinstance(comm, WorldComm):
        if mesh_only:
            raise NotImplementedError(
                f"{mesh_only} runs on the mesh tier only (one program over "
                "the ranks' stacked tensors); it has no world-tier route")
        return comm
    if not isinstance(comm, MeshComm):
        raise TypeError(
            "comm must be a mpi4jax_tpu_torch communicator (MeshComm or "
            f"WorldComm), got {type(comm).__qualname__}")
    return comm


def is_world(comm) -> bool:
    """True for a world-tier communicator (one process per rank)."""
    return not hasattr(comm, "axes")


def check_tensor(op: str, x: Any, comm):
    """``x`` must be a tensor of a supported dtype on the comm's device,
    with the mesh's rank dimensions leading."""
    if not isinstance(x, torch.Tensor):
        fail(f"x must be a torch.Tensor, got {_describe(x)}", op=op, comm=comm)
    try:
        _dtypes.check_supported(x.dtype)
    except TypeError as err:
        fail(str(err), op=op, comm=comm, x=x)
    lead = comm.layout_shape
    if tuple(x.shape[:len(lead)]) != lead:
        fail(f"the leading dimensions must be the mesh's rank axes {lead}",
             op=op, comm=comm, x=x, exc=ValueError)
    if x.device != comm.device:
        fail(f"x is on {x.device}, the comm on {comm.device}",
             op=op, comm=comm, x=x, exc=ValueError)
    return x


def check_world_tensor(op: str, x: Any, comm, name: str = "x"):
    """On a world comm ``x`` is this rank's tensor: a ``torch.Tensor`` on
    the comm's device (another device raises ``ValueError``: nothing is
    moved quietly)."""
    if not isinstance(x, torch.Tensor):
        fail(f"{name} must be a torch.Tensor, got {_describe(x)}", op=op,
             comm=comm)
    if x.device != comm.device:
        fail(f"{name} is on {x.device}, the comm on {comm.device}",
             op=op, comm=comm, x=x, exc=ValueError)
    return x


def check_wire_dtype(op: str, x, comm):
    """A dtype that the transport's wire cannot carry raises, with the
    op's context (``mpi4jax_tpu/utils/validation.py:122-133``)."""
    try:
        _dtypes.wire_code(x.dtype)
    except TypeError as err:
        raise ValidationError(f"{err}{op_context(op, comm, x)}") from None


def check_reduce_dtype(op_name: str, reduce_op, x, comm):
    """``reduce_op.check_dtype`` with the op's context."""
    try:
        reduce_op.check_dtype(x.dtype)
    except TypeError as err:
        raise ValidationError(f"{err}{op_context(op_name, comm, x)}") from None


def check_in_range(name: str, value: int, size: int, *, op=None, comm=None):
    """``value`` must lie in ``[0, size)``."""
    if not 0 <= value < size:
        context = op_context(op, comm) if op else ""
        raise ValidationError(
            f"{name}={value} out of range for communicator of size "
            f"{size}{context}")
    return value


def check_root(op: str, root, comm):
    """``root`` as an int rank of ``comm``: an int in ``[0, size)``."""
    root = check_static_int("root", root)
    return check_in_range("root", root, comm.size(), op=op, comm=comm)

