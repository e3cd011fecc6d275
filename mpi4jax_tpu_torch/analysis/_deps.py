"""Dependence analysis over one rank's extracted communication schedule.

The ordered-effect token chain serializes EVERY pair of world-tier ops —
that is the deadlock-freedom contract, but it is also the performance
ceiling: two transfers that share no channel and no data serialize
anyway.  This pass walks a rank's :class:`CommEvent` list (plus, on the
``analysis.check`` path, the payload provenance that ``_schedule.py``
records through every torch call) and keeps
only the dependence edges that are *semantically real*:

- ``channel``  — per-channel FIFO order: two send-parts to the same
  ``(comm, dest)``, or two recv-parts from the same ``(comm, source)``,
  must keep their relative order (the transport matches strictly
  in-order per channel);
- ``collective`` — collectives on one comm rendezvous at per-comm
  positions, so their sequence per comm is order-critical;
- ``wildcard`` — an ``ANY_SOURCE`` (or Status-filling) receive observes
  global arrival state: it conservatively serializes against every
  point-to-point event on its comm, in both directions;
- ``data``     — the payload of a later op is computed from an earlier
  op's output (payload provenance; absent on the virtual-world path,
  where posts still happen in program order so payload provenance
  cannot reorder — see ``_plan``).

Everything else — the pure token edge between ops on disjoint channels —
is *artificial serialization*, and the schedule compiler (``_plan``) is
licensed to overlap across it.

A copy of ``mpi4jax_tpu/analysis/_deps.py``, import-light like ``_match``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ._events import (
    ANY_SOURCE,
    COLLECTIVE_KINDS,
    CommEvent,
)

#: cap on a concurrency group's size: bounds the prover's per-group
#: interleaving enumeration (4! = 24 orders) and the runner's
#: outstanding-ticket window
MAX_GROUP = 4


def send_channels(ev: CommEvent) -> List[Tuple]:
    """(comm, dest_local) keys of every send-part this event carries."""
    if ev.kind == "send":
        return [(ev.comm, ev.dest)]
    if ev.kind == "sendrecv":
        return [(ev.comm, ev.dest)]
    if ev.kind == "shift2":
        return [(ev.comm, p) for p in (ev.lo, ev.hi)
                if p is not None and p >= 0]
    return []


def recv_channels(ev: CommEvent) -> List[Tuple]:
    """(comm, source_local) keys of every recv-part; ANY_SOURCE recvs
    return the wildcard key ``(comm, ANY_SOURCE)``."""
    if ev.kind == "recv":
        return [(ev.comm, ev.source)]
    if ev.kind == "sendrecv":
        return [(ev.comm, ev.source)]
    if ev.kind == "shift2":
        return [(ev.comm, p) for p in (ev.lo, ev.hi)
                if p is not None and p >= 0]
    return []


def is_wildcard(ev: CommEvent) -> bool:
    """True for events whose matching depends on global arrival state:
    ANY_SOURCE receives and Status-filling receives (the Status records
    which message arrived, so even a directed one is order-observable)."""
    if ev.status:
        return True
    return ev.source == ANY_SOURCE


class DepGraph:
    """True-dependence DAG over one rank's schedule.

    ``preds[j]`` holds every i < j that j depends on; ``kind[(i, j)]``
    names the strongest reason (data > wildcard > channel > collective).
    """

    _STRENGTH = {"data": 3, "wildcard": 2, "channel": 1, "collective": 0}

    def __init__(self, n: int):
        self.n = n
        self.preds: List[set] = [set() for _ in range(n)]
        self.kind: Dict[Tuple[int, int], str] = {}

    def add(self, i: int, j: int, kind: str):
        if i < 0 or i == j:
            return
        if i > j:
            i, j = j, i
        old = self.kind.get((i, j))
        if old is None or self._STRENGTH[kind] > self._STRENGTH[old]:
            self.kind[(i, j)] = kind
        self.preds[j].add(i)

    def depends(self, i: int, j: int) -> bool:
        """Direct edge i -> j (i < j)."""
        return i in self.preds[j]

    def edge_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for k in self.kind.values():
            out[k] = out.get(k, 0) + 1
        return out

    def artificial_pairs(self) -> int:
        """Adjacent event pairs whose only ordering was the token chain —
        the serialization the plan is licensed to drop."""
        return sum(
            1 for j in range(1, self.n) if (j - 1) not in self.preds[j]
        )


def build_rank_deps(
    events: Sequence[CommEvent],
    value_deps: Optional[Iterable[Tuple[int, int]]] = None,
) -> DepGraph:
    """The dependence DAG for one rank's ordered schedule.

    ``value_deps`` is the provenance-derived set of (producer_pos,
    consumer_pos) pairs (positions into ``events``); None on the
    virtual-world path, where payload provenance cannot constrain the
    plan (posts stay in program order — see module docstring).
    """
    n = len(events)
    g = DepGraph(n)

    last_send: Dict[Tuple, int] = {}   # channel key -> last position
    last_recv: Dict[Tuple, int] = {}
    last_coll: Dict[Tuple, int] = {}   # comm -> last collective position
    last_wild: Dict[Tuple, int] = {}   # comm -> last wildcard position
    last_p2p: Dict[Tuple, int] = {}    # comm -> last p2p-part position

    for j, ev in enumerate(events):
        comm = ev.comm
        sends = send_channels(ev)
        recvs = recv_channels(ev)
        wild = is_wildcard(ev) and bool(recvs)

        if ev.kind in COLLECTIVE_KINDS:
            g.add(last_coll.get(comm, -1), j, "collective")
            last_coll[comm] = j
            continue

        for key in sends:
            g.add(last_send.get(key, -1), j, "channel")
            last_send[key] = j
        if wild:
            # serializes against every p2p event on the comm, both ways
            g.add(last_p2p.get(comm, -1), j, "wildcard")
            g.add(last_wild.get(comm, -1), j, "wildcard")
            last_wild[comm] = j
            # and every recv channel on the comm: a directed recv after a
            # wildcard could otherwise steal the head it would have taken
            for key in list(last_recv):
                if key[0] == comm:
                    last_recv[key] = j
        else:
            for key in recvs:
                g.add(last_recv.get(key, -1), j, "channel")
                last_recv[key] = j
            # recvs after a wildcard on the comm are pinned behind it
            if recvs:
                g.add(last_wild.get(comm, -1), j, "wildcard")
        if sends or recvs:
            prev_wild = last_wild.get(comm, -1)
            if prev_wild >= 0 and prev_wild != j:
                g.add(prev_wild, j, "wildcard")
            last_p2p[comm] = j

    if value_deps:
        for i, j in value_deps:
            if 0 <= i < n and 0 <= j < n and i != j:
                g.add(min(i, j), max(i, j), "data")
    return g


def concurrency_groups(
    events: Sequence[CommEvent],
    deps: DepGraph,
    max_group: int = MAX_GROUP,
) -> List[List[int]]:
    """Partition the schedule into consecutive groups of mutually
    independent events.

    A group's members may complete in any order at run time (the runner
    defers their completion waits); correctness requires that no member
    depends on another.  Collectives, wildcard and Status receives stay
    solo — their blocking structure is the program's synchronization.
    """
    groups: List[List[int]] = []
    cur: List[int] = []
    for j, ev in enumerate(events):
        solo = ev.kind in COLLECTIVE_KINDS or is_wildcard(ev)
        fits = (
            cur
            and not solo
            and len(cur) < max_group
            and all(not deps.depends(i, j) for i in cur)
            # a solo event never shares a group, in either role
            and not (events[cur[0]].kind in COLLECTIVE_KINDS
                     or is_wildcard(events[cur[0]]))
        )
        if fits:
            cur.append(j)
        else:
            if cur:
                groups.append(cur)
            cur = [j]
    if cur:
        groups.append(cur)
    return groups


def _engine_root(comm: Tuple) -> Tuple:
    """Events on one socket-owning communicator tree share ONE progress
    engine (sub-comms borrow the parent's sockets); the lineage's first
    element identifies the tree."""
    return comm[:1] if comm else comm


def recv_post_point(
    events: Sequence[CommEvent],
    deps: DepGraph,
    j: int,
) -> int:
    """The earliest safe POST point for the recv at position ``j``.

    Encoding: ``post_at == j`` posts at the op's own position (no
    hoist); ``post_at == p < j`` posts the recv's descriptor immediately
    after op ``p``'s own post — i.e. inside op ``p``'s host callback,
    before any host compute that separates the two callbacks.  The
    progress engine then reads the wire while the host is still
    computing, which is where the overlap win lives.

    Safety: the engine executes its queue FIFO, so the recv's *wire*
    position is pinned right after op ``p`` — hoisting it past a
    same-engine op would delay that op's wire activity behind a blocking
    read (the classic symmetric-exchange deadlock: both ranks' sends
    stuck in the queue behind both ranks' reads).  The planner therefore
    hoists only across

    - the host-compute gap to the immediately preceding op
      (``p = j - 1``: wire order provably unchanged), and
    - ops on a *different* engine root (independent socket set and
      progress thread: no FIFO coupling), provided they are not
      dependence predecessors of the recv.

    The equivalence prover replays the exact reordered wire schedule, so
    even a planner bug here is caught before anything executes it.
    """
    ev = events[j]
    if ev.kind != "recv" or is_wildcard(ev) or j == 0:
        return j
    root = _engine_root(ev.comm)
    p = j - 1  # post inside the previous op's callback: wire order kept
    while p > 0:
        passed = events[p]
        if _engine_root(passed.comm) == root or deps.depends(p, j):
            break
        p -= 1
    return p
