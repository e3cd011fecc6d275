"""Topology of a world communicator: islands, leaders and tiers.

The counterpart of ``mpi4jax_tpu/topo/__init__.py`` (``:65-240``) for the
port's world tier.  At comm creation every rank contributes a host
fingerprint (hostname and boot id, the card count, and the
``MPI4JAX_TPU_FAKE_HOSTS`` virtual partition) through an allgather
(:func:`discover`), and the result is a :class:`Topology`: ranks sharing a
host form an island, each island's lowest rank is its leader, and on a
multi-island world the hierarchical allreduce (``hring``/``htree``)
applies.

Tiers.  The JAX package marks a rank backed by a TPU mesh ``"ici"``.
Here a rank whose comm lives on a CUDA device of a host with cards gets
that tier, under the same name, so that ``MPI4JAX_TPU_ICI_LEG=auto`` and
``_ici_leg.eligible`` keep the JAX semantics: the intra-island leg runs
on the card when every member of every multi-member island is backed by
one.  The card count is read from the ``/dev/nvidia<N>`` nodes, without
initializing CUDA.
"""

from __future__ import annotations

import os
import re
import socket
from typing import Dict, List, Optional, Sequence

FINGERPRINT_VERSION = 1


def parse_fake_hosts(spec: Optional[str], size: int
                     ) -> Optional[List[Optional[str]]]:
    """Parse ``MPI4JAX_TPU_FAKE_HOSTS`` (``r0,r1|r2,r3``: groups of world
    ranks separated by ``|``, tokens ``rN`` or ``N``) into a per-rank
    virtual host label, ``None`` for unlisted ranks, or ``None`` for an
    empty spec.  As the native parser: a malformed token or a rank listed
    twice raises; ranks out of range are ignored."""
    if not spec or not spec.strip():
        return None
    labels: List[Optional[str]] = [None] * size
    seen = set()
    for group_idx, group in enumerate(spec.split("|")):
        for tok in group.split(","):
            tok = tok.strip()
            if not tok:
                continue
            body = tok[1:] if tok[:1] in ("r", "R") else tok
            try:
                r = int(body)
            except ValueError:
                r = -1
            if r < 0 or (body and not body.isdigit()):
                raise ValueError(
                    f"cannot parse MPI4JAX_TPU_FAKE_HOSTS token {tok!r} "
                    "(expected rN or N, groups separated by |)")
            if r < size:
                # duplicates count for in-range ranks only, as natively
                if r in seen:
                    raise ValueError(
                        f"MPI4JAX_TPU_FAKE_HOSTS lists rank {r} twice")
                seen.add(r)
                labels[r] = f"fake-host-{group_idx}"
    return labels


def _boot_id() -> str:
    """A per-boot host identity: two ranks share a host when hostname and
    boot id agree."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        return ""


_CARD_NODE = re.compile(r"nvidia\d+")


def _card_count() -> int:
    """The ``/dev/nvidia<N>`` device nodes of this host (no CUDA call)."""
    try:
        return sum(1 for name in os.listdir("/dev")
                   if _CARD_NODE.fullmatch(name))
    except OSError:
        return 0


def local_fingerprint(rank: int, size: int, device=None) -> dict:
    """This rank's host fingerprint, as discovery allgathers it.
    ``cards`` counts the host's cards when the comm's ``device`` is a
    CUDA device, else 0 (a CPU rank is backed by no card)."""
    fake = parse_fake_hosts(os.environ.get("MPI4JAX_TPU_FAKE_HOSTS"), size)
    on_card = device is not None and getattr(device, "type", None) == "cuda"
    return {
        "v": FINGERPRINT_VERSION,
        "host": socket.gethostname(),
        "boot_id": _boot_id(),
        "fake": fake[rank] if fake else None,
        "cards": _card_count() if on_card else 0,
    }


class Topology:
    """The locality map of one world communicator.

    ``islands[i]`` is the sorted member list of island ``i``, the islands
    ordered by their lowest rank (the *leader*); ``tiers[r]`` is rank r's
    best local tier (``"ici"`` when a card backs it, else ``"shm"``)."""

    def __init__(self, fingerprints: Sequence[dict]):
        self.size = len(fingerprints)
        self.hosts: List[str] = [
            str(fp.get("fake") or f"{fp.get('host', '?')}|"
                                  f"{fp.get('boot_id', '')}")
            for fp in fingerprints]
        order: Dict[str, int] = {}
        self.island_of: List[int] = []
        for key in self.hosts:
            if key not in order:
                order[key] = len(order)
            self.island_of.append(order[key])
        self.islands: List[List[int]] = [[] for _ in range(len(order))]
        for rank, isl in enumerate(self.island_of):
            self.islands[isl].append(rank)
        self.leaders = [members[0] for members in self.islands]
        self.tiers = ["ici" if int(fp.get("cards") or 0) > 0 else "shm"
                      for fp in fingerprints]

    @property
    def n_islands(self) -> int:
        return len(self.islands)

    @property
    def multi(self) -> bool:
        """True when the hierarchical schedules have islands to use."""
        return self.n_islands > 1

    def island(self, rank: int) -> List[int]:
        return self.islands[self.island_of[rank]]

    def leader(self, rank: int) -> int:
        return self.leaders[self.island_of[rank]]

    def link(self, a: int, b: int) -> str:
        """The (a, b) link: ``self``, ``ici`` (both ranks on cards of one
        host), ``shm`` (one island) or ``tcp`` (across islands)."""
        if a == b:
            return "self"
        if self.island_of[a] != self.island_of[b]:
            return "tcp"
        if self.tiers[a] == "ici" and self.tiers[b] == "ici":
            return "ici"
        return "shm"

    def __repr__(self):
        return (f"Topology(size={self.size}, islands="
                f"{[len(m) for m in self.islands]})")


def build_topology(fingerprints: Sequence[dict]) -> Topology:
    """Group allgathered fingerprints into a :class:`Topology`."""
    return Topology(fingerprints)


#: the live Topology per native comm handle (the bridge registers it at
#: discovery and forgets it at finalize)
_by_handle: Dict[int, Topology] = {}


def get_topology(handle) -> Optional[Topology]:
    """The discovered topology of a live comm handle, or None."""
    return _by_handle.get(int(handle)) if handle is not None else None


def _register(handle, topology: Topology) -> None:
    _by_handle[int(handle)] = topology


def _forget(handle) -> None:
    _by_handle.pop(int(handle), None)


def discover(handle, rank: int, size: int, device=None) -> Topology:
    """The fingerprint allgather over a live comm.  Collective: every rank
    calls it at the same point (``bridge.comm_init`` does)."""
    from ._discover import discover as _impl

    return _impl(handle, rank, size, device)


from ._simulate import (  # noqa: E402
    simulate_hring_sum,
    simulate_htree_sum,
    simulate_ici_q_sum,
    simulate_rd_sum,
    simulate_ring_sum,
)

__all__ = [
    "Topology", "build_topology", "discover", "get_topology",
    "local_fingerprint", "parse_fake_hosts", "simulate_hring_sum",
    "simulate_htree_sum", "simulate_ici_q_sum", "simulate_rd_sum",
    "simulate_ring_sum",
]
