"""The collective algorithm names that ``algo=`` accepts, and their rules.

A copy of the names of ``mpi4jax_tpu/tune/__init__.py`` (``ALGO_CODES``,
``QUANT_ALGOS``, ``A2A_ALGOS``) and of ``tune._check_algo``, so that the
port's fronts reject what the JAX package's reject, with the same
exception, before they say what the mesh tier cannot take.  The codes
match the native transport's ``TpuCollAlgo`` (``native/tpucomm.h``), which
the world tier will use.
"""

from __future__ import annotations

from typing import Optional

ALGO_CODES = {"auto": 0, "ring": 1, "rd": 2, "tree": 3, "shm": 4,
              "qring": 5, "qrd": 6, "hring": 7, "htree": 8,
              "qalltoall": 9, "halltoall": 10, "hqalltoall": 11}
# quantized wire formats: allreduce only
QUANT_ALGOS = frozenset(("qring", "qrd"))
# the alltoall schedule family
A2A_ALGOS = frozenset(("qalltoall", "halltoall", "hqalltoall"))


def check_algo(algo: str, op: Optional[str] = None) -> str:
    """The canonical name of ``algo`` for ``op`` ("allreduce", "allgather"
    or "alltoall"); an unknown name, or one that ``op`` has no schedule
    for, raises ``ValueError``."""
    name = str(algo).strip().lower()
    if name in ("recursive_doubling", "recursive-doubling"):
        name = "rd"
    if name not in ALGO_CODES or name == "shm":
        raise ValueError(
            f"unknown collective algorithm {algo!r} "
            "(expected auto, ring, rd, tree, qring, qrd, hring, htree, "
            "qalltoall, halltoall, or hqalltoall)")
    if op == "allgather" and name in QUANT_ALGOS:
        raise ValueError(
            f"{name} is an allreduce-only algorithm: quantized wire "
            "formats are lossy and allgather is pure data movement")
    if op == "alltoall" and name not in ("auto", "ring") \
            and name not in A2A_ALGOS:
        raise ValueError(
            f"{name} is not an alltoall schedule (expected auto, ring, "
            "qalltoall, halltoall, or hqalltoall)")
    if op in ("allreduce", "allgather") and name in A2A_ALGOS:
        raise ValueError(
            f"{name} is an alltoall-only algorithm (the allreduce twins "
            "are qring/qrd and hring/htree)")
    return name
