"""The collective algorithm engine's default layer.

A copy of the default layer of ``mpi4jax_tpu/tune/__init__.py``
(``:191-214``, ``:455-511``, ``:986-993``): the decision tables that the
native transport resolves ``algo=None`` against, per op and payload size.
``install`` pushes the flat table, or on a comm with a multi-island
topology the hierarchical one, into the transport at comm creation, as
the JAX package's ``_post_init_setup`` does (``runtime/bridge.py:514-560``
there).  So with no tune cache and no override, the port runs the
schedule the JAX package would.

The persistent cache, ``set_algorithm`` and ``MPI4JAX_TPU_COLL_ALGO`` are
not ported (ROADMAP.md §1 item 6): with that variable set, comm creation
raises ``NotImplementedError`` (``check_knobs``) rather than run a schedule
that the JAX package would not.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..utils.algos import ALGO_CODES

OPS = ("allreduce", "allgather", "alltoall")
OP_KIND = {"allreduce": 0, "allgather": 1, "alltoall": 2}
#: the quantized twin an exact pick promotes to under compression="int8"
#: (tree's broadcast shape has none: its latency regime maps to qrd; a
#: hierarchical pick maps to the flat twin of its leader leg)
QUANT_TWIN = {"ring": "qring", "rd": "qrd", "tree": "qrd",
              "qring": "qring", "qrd": "qrd",
              "hring": "qring", "htree": "qrd"}

Entry = Tuple[int, str]
Table = Dict[str, List[Entry]]

#: (min_bytes ascending, algo): the native built-in heuristics
_DEFAULT_TABLE: Table = {
    "allreduce": [(0, "tree"), (64 * 1024, "ring")],
    "allgather": [(0, "ring")],
    "alltoall": [(0, "ring")],
}

#: on a comm with a multi-island topology, bandwidth-bound allreduces take
#: the hierarchical ring
_HIER_DEFAULT_TABLE: Table = {
    "allreduce": [(0, "tree"), (64 * 1024, "hring")],
    "allgather": [(0, "ring")],
    "alltoall": [(0, "ring")],
}

_topo_multi = False  # install() saw a multi-island topology


def check_knobs() -> None:
    """Raise for the selection knobs that are not ported."""
    if os.environ.get("MPI4JAX_TPU_COLL_ALGO", "").strip():
        raise NotImplementedError(
            "MPI4JAX_TPU_COLL_ALGO (the operator's algorithm override) is "
            "not ported: the port installs only the default decision table "
            "(ROADMAP.md §1 item 6); unset it")


def decision_table() -> Table:
    """The default layer in force: hierarchical once ``install`` has seen
    a multi-island topology."""
    base = _HIER_DEFAULT_TABLE if _topo_multi else _DEFAULT_TABLE
    return {op: list(base[op]) for op in OPS}


def get_algorithm(op: str, nbytes: int) -> str:
    """The algorithm name selected for ``op`` at ``nbytes`` (the TCP path;
    the shm arena, when a comm has one, wins over it)."""
    if op not in OPS:
        raise ValueError(f"unknown collective op {op!r} (expected one of "
                         f"{OPS})")
    algo = "auto"
    for min_bytes, name in decision_table()[op]:
        if int(nbytes) >= min_bytes:
            algo = name
    return algo


def quantized_algorithm(nbytes: int) -> str:
    """The quantized algorithm that carries an allreduce of ``nbytes``
    under ``compression="int8"``: the twin of the exact pick."""
    return QUANT_TWIN[get_algorithm("allreduce", nbytes)]


def install(world_size=None, topology=None) -> None:
    """Push the default table into the transport (process-wide); a
    multi-island ``topology`` flips it to the hierarchical one."""
    global _topo_multi
    del world_size  # keys the tune cache, which is not ported
    if topology is not None:
        _topo_multi = bool(getattr(topology, "multi", False))
    from ..runtime import bridge

    bridge.set_coll_table({
        OP_KIND[op]: [(mb, ALGO_CODES[name]) for mb, name in entries]
        for op, entries in decision_table().items()})
