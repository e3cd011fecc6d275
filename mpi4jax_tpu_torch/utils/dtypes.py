"""Supported dtypes and their wire codes.

The counterpart of ``mpi4jax_tpu/utils/dtypes.py`` on torch dtypes: the
reference's 14 MPI datatypes plus bfloat16, each with the integer code
that the native transport (``native/tpucomm.h``, ``TpuDtype``) knows it by.

numpy has no bfloat16, so the world tier stages a bf16 tensor as its int16
bits (``host_view``) and passes wire code 10: the transport then moves and
reduces real bf16.
"""

from __future__ import annotations

import torch

# name -> (dtype, wire code)
_TABLE = {
    "bool": (torch.bool, 0),
    "int8": (torch.int8, 1),
    "int16": (torch.int16, 2),
    "int32": (torch.int32, 3),
    "int64": (torch.int64, 4),
    "uint8": (torch.uint8, 5),
    "uint16": (torch.uint16, 6),
    "uint32": (torch.uint32, 7),
    "uint64": (torch.uint64, 8),
    "float16": (torch.float16, 9),
    "bfloat16": (torch.bfloat16, 10),
    "float32": (torch.float32, 11),
    "float64": (torch.float64, 12),
    "complex64": (torch.complex64, 13),
    "complex128": (torch.complex128, 14),
}

SUPPORTED_DTYPES = tuple(v[0] for v in _TABLE.values())
_CODES = {v[0]: v[1] for v in _TABLE.values()}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``."""
    return str(dtype).removeprefix("torch.")


def from_name(name: str) -> torch.dtype:
    """``"float32"`` -> ``torch.float32``; ``TypeError`` outside the
    table."""
    try:
        return _TABLE[name][0]
    except KeyError:
        raise TypeError(f"the transport does not carry {name}") from None


def check_supported(dtype: torch.dtype) -> None:
    """Raise ``TypeError`` for a dtype outside the table."""
    wire_code(dtype)


def wire_code(dtype: torch.dtype) -> int:
    """The transport's code for ``dtype``; ``TypeError`` for a dtype outside
    the table."""
    try:
        return _CODES[dtype]
    except KeyError:
        raise TypeError(
            f"mpi4jax_tpu_torch does not support dtype {dtype_name(dtype)}; "
            f"supported: {sorted(_TABLE)}"
        ) from None


def name_code(name: str) -> int:
    """The transport's code for a dtype named as in the table (a numpy
    dtype's name); ``TypeError`` outside it."""
    try:
        return _TABLE[name][1]
    except KeyError:
        raise TypeError(f"the transport does not carry {name}") from None


def host_view(t: torch.Tensor):
    """A CPU tensor's bytes as a numpy array: bf16 as its int16 bits."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)
