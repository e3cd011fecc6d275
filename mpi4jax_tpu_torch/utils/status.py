"""Receive-status introspection (the MPI_Status analog).

A copy of ``mpi4jax_tpu/utils/status.py:23-96``.  A :class:`Status` passed
to a world-tier ``recv`` or ``sendrecv`` is filled, when the receive runs,
from the native transport's frame header: the source, the tag and the byte
count that arrived.

Wildcards: ``ANY_TAG`` accepts any tag and ``ANY_SOURCE`` any peer (the
transport polls every peer socket and takes the first complete frame; the
order on each socket stays strict).  The status reports what arrived.
"""

from __future__ import annotations

import numpy as np
import torch

#: Accept a message with any tag (reported via :class:`Status`).
ANY_TAG = -1

#: Accept a message from any peer (first complete frame wins; the actual
#: sender is reported via :class:`Status`).
ANY_SOURCE = -2

#: Value of Status fields before any receive has filled them.
UNDEFINED = -32766


class Status:
    """Mutable record filled by the most recent receive it was passed to:
    ``Get_source`` / ``Get_tag`` / ``Get_count`` / ``Get_elements``, as
    ``mpi4py.MPI.Status``."""

    __slots__ = ("source", "tag", "count_bytes")

    def __init__(self):
        self.source = UNDEFINED
        self.tag = UNDEFINED
        self.count_bytes = UNDEFINED

    def _fill(self, source: int, tag: int, count_bytes: int) -> None:
        self.source = int(source)
        self.tag = int(tag)
        self.count_bytes = int(count_bytes)

    def Get_source(self) -> int:
        return self.source

    def Get_tag(self) -> int:
        return self.tag

    def Get_count(self, dtype=None) -> int:
        """Received size: bytes, or elements when ``dtype`` (a numpy or
        torch dtype) is given."""
        if dtype is None:
            return self.count_bytes
        if isinstance(dtype, torch.dtype):
            return self.count_bytes // dtype.itemsize
        return self.count_bytes // np.dtype(dtype).itemsize

    # mpi4py spells element counts Get_elements(datatype)
    Get_elements = Get_count

    def __repr__(self):
        return (
            f"Status(source={self.source}, tag={self.tag}, "
            f"count_bytes={self.count_bytes})"
        )
