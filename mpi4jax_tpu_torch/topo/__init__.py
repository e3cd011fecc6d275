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

``Topology.fingerprint`` (the key of the topology-aware tune cache),
``leg_bytes`` (the analytic intra/inter byte split of the allreduce and
alltoall families), ``describe`` and ``render`` are the JAX package's
(``:230-338`` there), as are ``synthetic_islands`` and the alltoall
simulators of ``_simulate.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
from typing import Dict, List, Optional, Sequence, Tuple

FINGERPRINT_VERSION = 1

#: transport tier names, best first
TIERS = ("ici", "shm", "tcp")

QUANT_BLOCK = 256  # the codec's block (native tpucomm_quant_packed_bytes)


def _quant_wire_bytes(nbytes: int) -> int:
    """On-wire bytes of an ``nbytes`` f32 payload under the int8 codec: one
    code per element and one f32 scale per 256-element block."""
    count = nbytes // 4
    return count + 4 * ((count + QUANT_BLOCK - 1) // QUANT_BLOCK)


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


def synthetic_islands(world_size: int, n_islands: int
                      ) -> Tuple[List[List[int]], str]:
    """A contiguous equal-split island map for virtual-scale testing:
    ``(islands, fake_hosts_spec)`` where ``islands`` is the member-rank
    lists in island order (the shape ``Topology.islands`` and the
    ``simulate_h*`` oracles take) and ``fake_hosts_spec`` is the
    ``MPI4JAX_TPU_FAKE_HOSTS`` string that produces exactly that
    partition under :func:`parse_fake_hosts`.  ``world_size`` must
    split evenly — a synthetic shape that silently dropped ranks
    would test the wrong world."""
    if n_islands < 1 or world_size % n_islands:
        raise ValueError(
            f"cannot split {world_size} ranks into {n_islands} equal "
            "islands")
    per = world_size // n_islands
    islands = [list(range(b, b + per))
               for b in range(0, world_size, per)]
    spec = "|".join(",".join(f"r{r}" for r in members)
                    for members in islands)
    return islands, spec


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

    def fingerprint(self) -> str:
        """Stable 12-hex-digit hash of the topology SHAPE (world size,
        island sizes in island order, per-island best tier) — the key
        of the topology-aware persistent tune cache.  Deliberately
        independent of hostnames: two deployments with the same shape
        share tuning."""
        shape = {
            "v": 1,
            "size": self.size,
            "islands": [len(m) for m in self.islands],
            "tiers": [
                min((self.tiers[r] for r in members),
                    key=TIERS.index)
                for members in self.islands
            ],
        }
        blob = json.dumps(shape, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:12]

    def leg_bytes(self, algo: str, nbytes: int) -> Dict[str, int]:
        """Analytic per-job wire-byte split of one collective of
        ``nbytes`` logical payload under ``algo``: total bytes crossing
        intra-island links vs inter-island (leader-tier) links, summed
        over all ranks.  Flat algorithms put everything on whichever
        links the schedule happens to cross; they are reported as
        ``inter`` when the world spans islands (the pessimal flat
        placement the hierarchy exists to avoid)."""
        n, L = self.size, self.n_islands
        if algo in ("hring", "htree"):
            intra = 2 * nbytes * sum(len(m) - 1 for m in self.islands)
            if L <= 1:
                inter = 0
            elif algo == "hring":
                # ring over the leaders: 2*(L-1)/L of the payload per
                # leader, each way
                inter = 2 * (L - 1) * nbytes
            else:
                # recursive doubling: every butterfly participant sends
                # the FULL payload per round, plus the non-power-of-two
                # fold's lend-and-return pair
                pof2 = 1
                while pof2 * 2 <= L:
                    pof2 *= 2
                rem = L - pof2
                inter = (pof2 * pof2.bit_length() - pof2 + 2 * rem) * nbytes
            return {"intra": int(intra), "inter": int(inter)}
        if algo in ("halltoall", "hqalltoall"):
            # nbytes is the per-rank send buffer; one chunk per peer
            chunk = nbytes // n
            packed = _quant_wire_bytes  # codec arithmetic, f32 elements
            intra = sum(len(m) * (len(m) - 1) for m in self.islands) * chunk
            inter = 0
            for ia, A in enumerate(self.islands):
                for ib, B in enumerate(self.islands):
                    if ia == ib:
                        continue
                    cross = len(A) * len(B) * chunk
                    # leader-tier block: ONE codec frame per (A, B) pair
                    # on the quantized leg
                    inter += (packed(cross) if algo == "hqalltoall"
                              else cross)
                    # staging hops: non-leader members of A hand their
                    # cross chunks to leader_a; leader_b fans out to the
                    # non-leader members of B — always exact bytes
                    intra += (len(A) - 1) * len(B) * chunk
                    intra += len(A) * (len(B) - 1) * chunk
            return {"intra": int(intra), "inter": int(inter)}
        if algo == "qalltoall":
            # flat quantized pairwise exchange: every off-rank chunk is
            # a codec frame
            chunk = nbytes // n
            total = n * (n - 1) * _quant_wire_bytes(chunk)
            if not self.multi:
                return {"intra": int(total), "inter": 0}
            return {"intra": 0, "inter": int(total)}
        if algo == "alltoall":
            # flat exact pairwise exchange: (n-1) off-rank chunks out of
            # every rank
            total = n * (n - 1) * (nbytes // n)
            if not self.multi:
                return {"intra": int(total), "inter": 0}
            return {"intra": 0, "inter": int(total)}
        total = 2 * (n - 1) * nbytes  # ring-style total wire bytes
        if not self.multi:
            return {"intra": int(total), "inter": 0}
        return {"intra": 0, "inter": int(total)}

    def describe(self) -> dict:
        """Diag/bench-friendly summary."""
        return {
            "size": self.size,
            "n_islands": self.n_islands,
            "islands": [list(m) for m in self.islands],
            "leaders": list(self.leaders),
            "tiers": list(self.tiers),
            "fingerprint": self.fingerprint(),
        }

    def render(self) -> str:
        """One-line island map, e.g.
        ``island0[r0 r1 (shm)] | island1[r2 r3 (shm)] inter=tcp``."""
        parts = []
        for i, members in enumerate(self.islands):
            tier = min((self.tiers[r] for r in members), key=TIERS.index)
            ranks = " ".join(f"r{r}" for r in members)
            parts.append(f"island{i}[{ranks} ({tier})]")
        joined = " | ".join(parts)
        return joined + (" inter=tcp" if self.multi else " (single island)")

    def __repr__(self):
        return (f"Topology(size={self.size}, islands="
                f"{[len(m) for m in self.islands]}, "
                f"fingerprint={self.fingerprint()})")


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
    simulate_halltoall,
    simulate_hqalltoall,
    simulate_hring_sum,
    simulate_htree_sum,
    simulate_ici_q_sum,
    simulate_qalltoall,
    simulate_rd_sum,
    simulate_ring_sum,
)

__all__ = [
    "TIERS", "Topology", "build_topology", "discover", "get_topology",
    "local_fingerprint", "parse_fake_hosts", "synthetic_islands",
    "simulate_halltoall", "simulate_hqalltoall", "simulate_hring_sum",
    "simulate_htree_sum", "simulate_ici_q_sum", "simulate_qalltoall",
    "simulate_rd_sum", "simulate_ring_sum",
]
