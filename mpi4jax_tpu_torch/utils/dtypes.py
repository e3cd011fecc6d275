"""Supported dtypes.

The counterpart of ``mpi4jax_tpu/utils/dtypes.py`` on torch dtypes: the
reference's 14 MPI datatypes plus bfloat16.  The port has no native wire
protocol yet, so the table has no wire codes.
"""

from __future__ import annotations

import torch

_TABLE = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

SUPPORTED_DTYPES = tuple(_TABLE.values())


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``."""
    return str(dtype).removeprefix("torch.")


def check_supported(dtype: torch.dtype) -> None:
    """Raise ``TypeError`` for a dtype outside the table."""
    if dtype not in SUPPORTED_DTYPES:
        raise TypeError(
            f"mpi4jax_tpu_torch does not support dtype {dtype_name(dtype)}; "
            f"supported: {sorted(_TABLE)}"
        )


def is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)
