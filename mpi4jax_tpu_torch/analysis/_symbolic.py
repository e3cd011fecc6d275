"""Rank-symbolic schedule analysis: verify once per equivalence class.

A copy of ``mpi4jax_tpu/analysis/_symbolic.py``, ``SYMBOLIC_MIN_NP`` = 9
as there.

SPMD programs are rank-symmetric by construction: every rank runs the
same code with peers/roots written as affine-mod expressions of its own
rank (``(rank±k) mod np``, island-relative forms under hierarchical
partitions).  This module exploits that symmetry so the match simulation
(``_match.match_schedules``) and the plan equivalence prover
(``_plan.prove_plan``) run once per *class representative* instead of
once per rank — the step that turns the np≤8 linter into the np=512
scale-proof layer.

The model, in three layers:

1. **Canonicalization / partition** (:func:`partition_schedules`) —
   each rank's schedule is rewritten into a rank-free *descriptor*:
   every field that matching compares stays concrete (kind, comm,
   reduce op, root, tags, dtype, shape, status, site), while peer
   values (dest/source/lo/hi) are abstracted into first-appearance
   alias ids — capturing *which* peers are equal within the rank
   without naming them.  Ranks with equal descriptors seed a partition
   that is then refined to a fixpoint on peer-class constancy: two
   ranks stay equivalent only if their k-th peers are themselves
   equivalent, for every k.  Island-structured programs (hierarchical
   ``FAKE_HOSTS`` partitions, non-contiguous islands, uneven
   partitions) fall out of the refinement with no special casing: the
   boundary roles become their own classes.

2. **Quotient simulation** (:func:`match_schedules_symbolic`) — all
   members of a class advance in lockstep with their representative.
   Point-to-point channels are grouped into *slots*: one slot per
   (class, concrete-peer-vector) send direction, valid only when the
   peer map is a bijection onto the target class and every consuming
   receive pops the whole slot at once — exactly the condition under
   which every concrete channel in the slot provably carries the same
   FIFO content.  Anything outside the model (wildcard receives,
   sub-communicators, fan-in/fan-out p2p, overlapping channel
   families) raises and the caller falls back to the concrete path —
   the fallback is *sound*, never silent.

3. **Finding lift** — a clean representative comparison proves every
   member clean (field constancy within the class); a dirty one is
   re-run per member through the concrete comparators
   (``compare_p2p``/``compare_collective``/``wait_graph_findings``),
   so symbolic findings are byte-identical to the concrete
   simulation's (the differential gate in ``tests/test_symbolic.py``
   pins this across the verify-corpus at np ∈ {2..8}).

On top sits the np-rescaling layer the scale harness uses
(:func:`fit_peer_form` / :func:`instantiate_peer`): peers observed at
two small calibration sizes are fitted to affine-mod forms
(const, np-1-k, ``(rank+s) mod np``, non-wrapping shift-with-wall,
island-block) and re-instantiated at any target np.  A peer that fits
no form keeps the program honestly concrete-only.

Knob: ``MPI4JAX_TPU_ANALYZE_SYMBOLIC=auto|off`` (strict parse; read
directly from the environment so this module stays standalone-loadable,
the same contract as ``_match.default_coalesce_bytes``; mirrored by
``utils.config.analyze_symbolic_mode``).  ``off`` pins the concrete path bit-for-bit;
``auto`` engages the symbolic path from ``SYMBOLIC_MIN_NP`` ranks up.
"""

from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import _match
from ._events import (
    ANY_SOURCE,
    COLLECTIVE_KINDS,
    CommEvent,
    Finding,
)

#: world sizes below this stay on the concrete path under ``auto`` —
#: small worlds are already fast, and keeping them concrete pins the
#: historic behavior of every existing test and golden bit-for-bit
SYMBOLIC_MIN_NP = 9

#: the world communicator key (the only comm the symbolic model serves;
#: sub-communicator schedules fall back to the concrete path)
WORLD_KEY = (0,)

#: peer-carrying event fields, in the fixed order descriptors use
PEER_FIELDS = ("dest", "source", "lo", "hi")


class Uncanonicalizable(Exception):
    """The schedules cannot be canonicalized under rank symmetry
    (wildcard receives, sub-communicators, non-contiguous rank sets);
    the caller must use the concrete path."""


class FallbackNeeded(Exception):
    """A lockstep invariant failed *during* symbolic analysis (p2p
    fan-in/fan-out, overlapping channel families, finding overflow);
    the caller must rerun the concrete path.  Sound: nothing has been
    reported yet when this raises."""


def symbolic_mode() -> str:
    """``MPI4JAX_TPU_ANALYZE_SYMBOLIC`` as "auto" | "off" — strict like
    ``utils.config.quant_mode``: a typo'd mode aborts loudly instead of
    silently changing which verification path ran.  Read from the
    environment directly so the analysis package stays standalone-
    loadable; the knob is declared in ``config.KNOBS``."""
    raw = os.environ.get("MPI4JAX_TPU_ANALYZE_SYMBOLIC")
    if raw is None or not raw.strip():
        return "auto"
    v = raw.strip()
    if v in ("auto", "off"):
        return v
    raise ValueError(
        f"cannot parse MPI4JAX_TPU_ANALYZE_SYMBOLIC={raw!r} "
        "(expected auto or off)")


# ---------------------------------------------------------------------------
# canonicalization: rank descriptors and the symmetry partition


@dataclass
class SymmetryPartition:
    """Equivalence classes of ranks under schedule symmetry.

    ``classes`` holds each class's members ascending; classes are
    ordered by their smallest member, so ``classes[0]`` always contains
    rank 0 and the representative list starts with it."""

    world_size: int
    class_of: List[int]                  # rank -> class index
    classes: List[Tuple[int, ...]]       # class index -> ascending members

    @property
    def reps(self) -> List[int]:
        return [members[0] for members in self.classes]

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def to_json(self) -> dict:
        return {
            "world_size": self.world_size,
            "n_classes": self.n_classes,
            "classes": [
                {"representative": members[0], "size": len(members)}
                for members in self.classes
            ],
        }


def _rank_descriptor(events: Sequence[CommEvent]) -> tuple:
    """The rank-free canonical form of one rank's schedule: concrete
    everywhere matching compares fields, peer values abstracted into
    first-appearance alias ids (so intra-rank channel aliasing — two
    sends to *the same* peer — survives canonicalization)."""
    alias: Dict[int, int] = {}
    desc = []
    for ev in events:
        peers = []
        for f in PEER_FIELDS:
            v = getattr(ev, f)
            if v is None:
                peers.append((f, None))
            elif f in ("lo", "hi") and v < 0:
                peers.append((f, "wall"))
            elif f == "source" and v == ANY_SOURCE:
                raise Uncanonicalizable(
                    "ANY_SOURCE receive: wildcard matching is "
                    "service-order dependent and has no class-uniform "
                    "channel state")
            else:
                peers.append((f, ("peer", alias.setdefault(v, len(alias)))))
        desc.append((
            ev.kind, tuple(ev.comm), ev.reduce_op, ev.dtype,
            None if ev.shape is None else tuple(ev.shape),
            bool(ev.status), ev.site, ev.tag, ev.sendtag, ev.recvtag,
            ev.root, tuple(peers),
        ))
    return tuple(desc)


def partition_schedules(
    schedules: Dict[int, List[CommEvent]],
    comms: Optional[Dict[Tuple, Tuple[int, ...]]] = None,
) -> SymmetryPartition:
    """Partition ranks into symmetry classes, or raise
    :class:`Uncanonicalizable`.

    Two ranks land in one class iff (a) their canonical descriptors are
    equal and (b) — refined to a fixpoint — every peer reference of one
    points into the same class as the corresponding reference of the
    other.  The refinement is what separates island-boundary roles
    (first/last island, uneven tail islands) without any topology
    input."""
    ranks = sorted(schedules)
    n = len(ranks)
    if n == 0 or ranks != list(range(n)):
        raise Uncanonicalizable("non-contiguous rank set")
    for key, members in (comms or {}).items():
        if tuple(key) != WORLD_KEY or tuple(members) != tuple(range(n)):
            raise Uncanonicalizable(
                "sub-communicator schedule: the symbolic model serves "
                "the world communicator only")

    by_desc: Dict[tuple, List[int]] = {}
    for r in ranks:
        for ev in schedules[r]:
            if tuple(ev.comm) != WORLD_KEY:
                raise Uncanonicalizable("event on a sub-communicator")
            for f in ("dest", "source"):
                v = getattr(ev, f)
                if v is not None and v != ANY_SOURCE \
                        and not (0 <= v < n):
                    raise Uncanonicalizable(
                        f"{f}={v} outside the world")
        by_desc.setdefault(_rank_descriptor(schedules[r]), []).append(r)

    classes = sorted(by_desc.values(), key=lambda ms: ms[0])
    class_of = [0] * n
    for ci, ms in enumerate(classes):
        for r in ms:
            class_of[r] = ci

    def peer_class_signature(r: int) -> tuple:
        sig = []
        for ev in schedules[r]:
            for f in PEER_FIELDS:
                v = getattr(ev, f)
                if v is None or (f in ("lo", "hi") and v < 0):
                    sig.append(None)
                else:
                    sig.append(class_of[v])
        return tuple(sig)

    while True:
        split_any = False
        new_classes: List[List[int]] = []
        for ms in classes:
            by_sig: Dict[tuple, List[int]] = {}
            for r in ms:
                by_sig.setdefault(peer_class_signature(r), []).append(r)
            parts = sorted(by_sig.values(), key=lambda g: g[0])
            if len(parts) > 1:
                split_any = True
            new_classes.extend(parts)
        if not split_any:
            break
        classes = sorted(new_classes, key=lambda g: g[0])
        for ci, ms in enumerate(classes):
            for r in ms:
                class_of[r] = ci

    return SymmetryPartition(
        world_size=n,
        class_of=class_of,
        classes=[tuple(ms) for ms in classes],
    )


# ---------------------------------------------------------------------------
# quotient simulation


class _QuotientSim:
    """Lockstep class-level replay of :func:`_match.match_schedules`.

    Channel *slots* — one per (sending class, concrete peer vector) —
    stand in for the O(np²) concrete channels: a slot is only admitted
    when its peer map is a bijection onto the target class and every
    receive that consumes it pops the whole slot at once, which is
    exactly the condition under which all its concrete channels carry
    identical FIFO state.  Violations raise :class:`FallbackNeeded`.
    """

    def __init__(self, schedules, part: SymmetryPartition,
                 deliveries=None, service_order=None):
        self.schedules = schedules
        self.part = part
        self.classes = part.classes
        self.reps = part.reps
        self.findings: List[Finding] = []
        self.deliveries = deliveries
        if deliveries is not None:
            deliveries.setdefault("p2p", {})
            deliveries.setdefault("coll", {})
        self.service = (list(service_order) if service_order is not None
                        else list(range(len(self.classes))))
        self.pc = [0] * len(self.classes)
        self.steps = 0
        self._sent: set = set()          # (class, pos) combined-op pushes
        self._build_slots()

    # -- static slot derivation --------------------------------------

    def _peer_vector(self, ci: int, pos: int, field: str):
        members = self.classes[ci]
        rep_v = getattr(self.schedules[members[0]][pos], field)
        if rep_v is None or (field in ("lo", "hi") and rep_v < 0):
            for m in members[1:]:
                v = getattr(self.schedules[m][pos], field)
                if not (v is None or (field in ("lo", "hi") and v < 0)):
                    raise FallbackNeeded("wall/peer mix within a class")
            return None
        vec = tuple(getattr(self.schedules[m][pos], field)
                    for m in members)
        if any(not isinstance(v, int) or v < 0 for v in vec):
            raise FallbackNeeded("wall/peer mix within a class")
        return vec

    def _build_slots(self):
        sched_len = [len(self.schedules[rep]) for rep in self.reps]
        # send directions first: every channel family a send ever feeds
        self.slot_info: List[Tuple[int, tuple]] = []   # slot -> (ci, vec)
        slot_ids: Dict[Tuple[int, tuple], int] = {}
        edge_slot: Dict[Tuple[int, int], int] = {}     # (src,dst) -> slot
        self.send_slot: Dict[Tuple[int, int, str], Optional[int]] = {}
        for ci, members in enumerate(self.classes):
            rep = members[0]
            for pos in range(sched_len[ci]):
                ev = self.schedules[rep][pos]
                if ev.kind == "send":
                    fields = ("dest",)
                elif ev.kind == "sendrecv":
                    fields = ("dest",)
                elif ev.kind == "shift2":
                    fields = ("lo", "hi")
                else:
                    continue
                for f in fields:
                    vec = self._peer_vector(ci, pos, f)
                    if vec is None:
                        self.send_slot[(ci, pos, f)] = None
                        continue
                    key = (ci, vec)
                    slot = slot_ids.get(key)
                    if slot is None:
                        if len(set(vec)) != len(vec):
                            raise FallbackNeeded(
                                "p2p fan-in: send peers not distinct "
                                "within the class")
                        tgt = self.part.class_of[vec[0]]
                        if len(vec) != len(self.classes[tgt]):
                            raise FallbackNeeded(
                                "p2p send image does not cover the "
                                "target class")
                        slot = len(self.slot_info)
                        self.slot_info.append((ci, vec))
                        slot_ids[key] = slot
                        for k, src in enumerate(members):
                            edge = (src, vec[k])
                            if edge_slot.setdefault(edge, slot) != slot:
                                raise FallbackNeeded(
                                    "overlapping channel families: one "
                                    "concrete channel fed by two slots")
                    self.send_slot[(ci, pos, f)] = slot
        # receive directions: bind each to the one slot that feeds it
        self.recv_bind: Dict[Tuple[int, int, str], Optional[int]] = {}
        self.recv_src: Dict[Tuple[int, int, str], tuple] = {}
        for ci, members in enumerate(self.classes):
            rep = members[0]
            for pos in range(sched_len[ci]):
                ev = self.schedules[rep][pos]
                if ev.kind in ("recv", "sendrecv"):
                    fields = ("source",)
                elif ev.kind == "shift2":
                    fields = ("lo", "hi")
                else:
                    continue
                for f in fields:
                    vec = self._peer_vector(ci, pos, f)
                    if vec is None:
                        continue
                    owners = {edge_slot.get((vec[k], d))
                              for k, d in enumerate(members)}
                    if len(owners) != 1:
                        raise FallbackNeeded(
                            "receive channels straddle channel "
                            "families")
                    owner = owners.pop()
                    if owner is not None:
                        oci, ovec = self.slot_info[owner]
                        if len(self.classes[oci]) != len(members):
                            raise FallbackNeeded(
                                "receive does not drain its whole "
                                "channel family")
                    self.recv_bind[(ci, pos, f)] = owner
                    self.recv_src[(ci, pos, f)] = vec
        self.fifo: Dict[int, deque] = {
            s: deque() for s in range(len(self.slot_info))}

    # -- lockstep advance --------------------------------------------

    def _current(self, ci: int):
        sched = self.schedules[self.reps[ci]]
        pos = self.pc[ci]
        return sched[pos] if pos < len(sched) else None

    def _push(self, ci: int, pos: int, field: str):
        slot = self.send_slot[(ci, pos, field)]
        if slot is not None:
            self.fifo[slot].append((ci, pos, field))

    def _extend(self, found: List[Finding]):
        self.findings.extend(found)
        if len(self.findings) > _match.MAX_FINDINGS:
            raise FallbackNeeded(
                "finding overflow: the concrete path owns the "
                "truncation point")

    def _match_pair(self, sc, sp, sfield, ci, pos, rfield):
        """One slot pop: the sending (class, pos, part) meets the
        receiving (class, pos, part).  Clean at the representative ⇒
        clean for every member (field constancy within the class);
        dirty ⇒ re-run the concrete comparator per member, so the
        lifted findings (messages embed concrete ranks) are
        byte-identical to the concrete simulation's."""
        members = self.classes[ci]
        svec = self.recv_src[(ci, pos, rfield)]
        rep_src = svec[0]
        send_rep = _match.send_part_event(
            self.schedules[rep_src][sp], dest=members[0])
        recv_rep = self.schedules[members[0]][pos]
        probe = _match.compare_p2p(send_rep, recv_rep)
        if probe:
            found = []
            for k, d in enumerate(members):
                s_ev = _match.send_part_event(
                    self.schedules[svec[k]][sp], dest=d)
                found.extend(_match.compare_p2p(
                    s_ev, self.schedules[d][pos]))
            self._extend(found)
        if self.deliveries is not None:
            # key on the slot's stable identity and the events'
            # original idx (not positions): the prover compares these
            # records across reordered configurations, exactly like the
            # concrete recorder's (send_rank, send_idx, ...) tuples
            slot_key = self.slot_info[self.recv_bind[(ci, pos, rfield)]]
            self.deliveries["p2p"].setdefault(slot_key, []).append(
                (sc, send_rep.idx, send_rep.tag, ci, recv_rep.idx))

    def _complete_recv(self, ci, pos, rfield) -> bool:
        slot = self.recv_bind.get((ci, pos, rfield))
        if slot is None:
            return False
        q = self.fifo[slot]
        if not q:
            return False
        sc, sp, sfield = q.popleft()
        self._match_pair(sc, sp, sfield, ci, pos, rfield)
        return True

    def _advance(self, ci: int) -> bool:
        ev = self._current(ci)
        if ev is None:
            return False
        pos = self.pc[ci]
        if ev.kind == "send":
            self._push(ci, pos, "dest")
            self.pc[ci] += 1
            return True
        if ev.kind == "sendrecv":
            if (ci, pos) not in self._sent:
                self._push(ci, pos, "dest")
                self._sent.add((ci, pos))
            if self._complete_recv(ci, pos, "source"):
                self.pc[ci] += 1
                return True
            return False
        if ev.kind == "shift2":
            if (ci, pos) not in self._sent:
                for f in ("lo", "hi"):
                    self._push(ci, pos, f)
                self._sent.add((ci, pos))
            needed = [f for f in ("lo", "hi")
                      if (ci, pos, f) in self.recv_src]
            for f in needed:
                slot = self.recv_bind[(ci, pos, f)]
                if slot is None or not self.fifo[slot]:
                    return False
            for f in needed:
                q = self.fifo[self.recv_bind[(ci, pos, f)]]
                sc, sp, sfield = q.popleft()
                self._match_pair(sc, sp, sfield, ci, pos, f)
            self.pc[ci] += 1
            return True
        if ev.kind == "recv":
            if self._complete_recv(ci, pos, "source"):
                self.pc[ci] += 1
                return True
            return False
        if ev.kind in COLLECTIVE_KINDS:
            return self._advance_collective(ci, ev)
        return False

    def _advance_collective(self, ci, ev) -> bool:
        arrived_reps = []
        for cj in range(len(self.classes)):
            cur = self._current(cj)
            if cur is None or cur.kind not in COLLECTIVE_KINDS \
                    or tuple(cur.comm) != WORLD_KEY:
                return False
            arrived_reps.append(cur)
        ref_sig = arrived_reps[0].collective_signature()
        if any(e.collective_signature() != ref_sig
               for e in arrived_reps[1:]):
            # dirty rendezvous: lift per member, world-rank order, the
            # exact list the concrete simulation hands compare_collective
            full = [self.schedules[m][self.pc[self.part.class_of[m]]]
                    for m in range(self.part.world_size)]
            self._extend(_match.compare_collective(full))
        if self.deliveries is not None:
            self.deliveries["coll"].setdefault(WORLD_KEY, []).append(
                (arrived_reps[0].kind,
                 tuple(sorted((cj, arrived_reps[cj].idx)
                              for cj in range(len(self.classes))))))
        for cj in range(len(self.classes)):
            self.pc[cj] += 1
        return True

    # -- stall classification, leftovers -----------------------------

    def _stall_findings(self):
        done_ranks = set()
        blocked: Dict[int, CommEvent] = {}
        for ci, members in enumerate(self.classes):
            if self._current(ci) is None:
                done_ranks.update(members)
            else:
                pos = self.pc[ci]
                for m in members:
                    blocked[m] = self.schedules[m][pos]
        done = frozenset(done_ranks)
        stragglers_cache: Optional[Tuple[int, ...]] = None
        waits_on: Dict[int, Tuple[int, ...]] = {}
        for r in sorted(blocked):
            ev = blocked[r]
            if ev.kind in COLLECTIVE_KINDS:
                if stragglers_cache is None:
                    out = []
                    for m in range(self.part.world_size):
                        cur = blocked.get(m)
                        if m in done or (
                            cur is not None
                            and (cur.kind not in COLLECTIVE_KINDS
                                 or tuple(cur.comm) != WORLD_KEY)
                        ):
                            out.append(m)
                    stragglers_cache = tuple(out)
                waits_on[r] = stragglers_cache
            elif ev.kind in ("recv", "sendrecv"):
                waits_on[r] = (ev.source,)
            elif ev.kind == "shift2":
                ci = self.part.class_of[r]
                pos = self.pc[ci]
                missing = []
                for f in ("lo", "hi"):
                    if (ci, pos, f) not in self.recv_src:
                        continue
                    slot = self.recv_bind[(ci, pos, f)]
                    if slot is None or not self.fifo[slot]:
                        missing.append(getattr(ev, f))
                waits_on[r] = tuple(missing)
            else:
                waits_on[r] = ()
        self._extend(
            _match.wait_graph_findings(blocked, waits_on, done))

    def _leftover_findings(self):
        found = []
        for slot, q in self.fifo.items():
            if not q:
                continue
            sc, sp, sfield = q[0]
            oci, ovec = self.slot_info[slot]
            for k, src in enumerate(self.classes[oci]):
                dst = ovec[k]
                ev = _match.send_part_event(
                    self.schedules[src][sp], dest=dst)
                found.append(Finding(
                    "unmatched_send",
                    f"rank {ev.rank} sends to rank {dst} (tag {ev.tag}) "
                    "but no matching receive ever runs",
                    ranks=(ev.rank, dst), comm=WORLD_KEY,
                    sites=(f"rank {ev.rank}: {ev.describe()}",),
                ))
        self._extend(found)

    def run(self) -> List[Finding]:
        total = sum(len(self.schedules[rep]) for rep in self.reps)
        for _ in range(2 * total + 2):
            progressed = False
            for ci in self.service:
                while self._advance(ci):
                    progressed = True
                    self.steps += 1
            if not progressed:
                break
        self._stall_findings()
        self._leftover_findings()
        self._extend(_match.order_critical_findings(
            self.schedules, {WORLD_KEY:
                             tuple(range(self.part.world_size))}))
        return self.findings


def match_schedules_symbolic(
    schedules: Dict[int, List[CommEvent]],
    comms: Dict[Tuple, Tuple[int, ...]],
    partition: SymmetryPartition,
    deliveries: Optional[dict] = None,
    service_order: Optional[Sequence[int]] = None,
    stats: Optional[dict] = None,
) -> List[Finding]:
    """Class-level replay of :func:`_match.match_schedules` under a
    symmetry ``partition`` (see :func:`partition_schedules`).

    ``service_order`` is over *class indices* (the prover rotates it).
    ``deliveries`` receives the quotient-level match record — per-slot
    p2p orders and class-level collective rendezvous — comparable
    across configurations that share the partition.  Raises
    :class:`FallbackNeeded` when a lockstep invariant fails; callers
    rerun the concrete path."""
    sim = _QuotientSim(schedules, partition, deliveries=deliveries,
                       service_order=service_order)
    findings = sim.run()
    if stats is not None:
        stats["steps"] = sim.steps
        stats["classes"] = partition.n_classes
    return findings


def verify_schedules(
    schedules: Dict[int, List[CommEvent]],
    comms: Dict[Tuple, Tuple[int, ...]],
    deliveries: Optional[dict] = None,
    stats: Optional[dict] = None,
) -> Tuple[List[Finding], Optional[SymmetryPartition]]:
    """Match ``schedules`` by the cheapest sound path: symbolic when
    the knob allows, the world is at least ``SYMBOLIC_MIN_NP`` ranks,
    and the program canonicalizes; concrete otherwise.  Returns
    ``(findings, partition_or_None)`` — the partition is returned even
    when the quotient simulation fell back, so callers can still
    symmetry-collapse the report."""
    part = None
    if symbolic_mode() == "auto" and len(schedules) >= SYMBOLIC_MIN_NP:
        try:
            part = partition_schedules(schedules, comms)
        except Uncanonicalizable:
            part = None
        if part is not None:
            try:
                findings = match_schedules_symbolic(
                    schedules, comms, part, deliveries=deliveries,
                    stats=stats)
                if stats is not None:
                    stats["mode"] = "symbolic"
                return findings, part
            except FallbackNeeded:
                pass
    findings = _match.match_schedules(schedules, comms,
                                      deliveries=deliveries, stats=stats)
    if stats is not None:
        stats["mode"] = "concrete"
    return findings, part


# ---------------------------------------------------------------------------
# quotient equivalence prover


def prove_plan_symbolic(events_by_rank, comms, plan, partition,
                        max_interleavings: Optional[int] = None):
    """Symbolic twin of :func:`_plan.prove_plan`: one replay per
    configuration at class granularity, with rank-service rotations
    quotiented to class-service rotations — what makes the proof
    budget independent of np (concretely, np=512 needs 512 rotations
    and blows the MAX_INTERLEAVINGS budget; symbolically it needs one
    per class).

    Returns ``plan.proved`` on success, or ``None`` when the plan is
    outside the symbolic model (per-class planned orders diverge, or a
    concurrency group has realizable non-post orders) — the caller
    then runs the concrete prover."""
    from . import _plan as P

    if max_interleavings is None:
        max_interleavings = P.MAX_INTERLEAVINGS
    ranks = sorted(events_by_rank)
    planned = {r: P._planned_order(events_by_rank[r], plan.ranks[r])
               for r in ranks}
    for members in partition.classes:
        first = planned[members[0]]
        if any(planned[m] != first for m in members[1:]):
            return None
    for r in ranks:
        for g in plan.ranks[r].groups:
            if len(g) >= 2 and P._group_interleavings(
                    events_by_rank[r], g):
                # multi-engine riffles are per-rank-asymmetric
                # configurations the lockstep model cannot express
                return None

    def sim(order_by_class, service):
        schedules = {
            r: [events_by_rank[r][p]
                for p in order_by_class[partition.class_of[r]]]
            for r in ranks
        }
        deliv: dict = {}
        findings = match_schedules_symbolic(
            schedules, comms, partition, deliveries=deliv,
            service_order=service)
        return {f.kind for f in findings}, deliv

    identity = {ci: list(range(len(events_by_rank[rep])))
                for ci, rep in enumerate(partition.reps)}
    planned_by_class = {ci: planned[rep]
                        for ci, rep in enumerate(partition.reps)}
    try:
        base_kinds, base_deliv = sim(identity, None)
        nclasses = partition.n_classes
        configs = [(planned_by_class, None)]
        for shift in range(1, nclasses):
            svc = list(range(nclasses))
            configs.append((planned_by_class, svc[shift:] + svc[:shift]))
        exhaustive = len(configs) <= max_interleavings
        if not exhaustive:
            configs = configs[:max_interleavings]
        failures: List[str] = []
        for i, (orders, service) in enumerate(configs):
            kinds, deliv = sim(orders, service)
            new_kinds = kinds - base_kinds
            if new_kinds:
                failures.append(
                    f"interleaving {i}: new finding kind(s) "
                    f"{sorted(new_kinds)}")
            elif deliv != base_deliv:
                failures.append(
                    f"interleaving {i}: per-channel delivery order "
                    "changed")
            if failures:
                break
    except FallbackNeeded:
        return None

    plan.proof = {
        "interleavings": len(configs),
        "exhaustive": exhaustive,
        "base_finding_kinds": sorted(base_kinds),
        "failures": failures,
        "symmetry_classes": partition.n_classes,
    }
    plan.proved = not failures and exhaustive
    if failures:
        plan.reasons.extend(failures)
    elif not exhaustive:
        plan.reasons.append(
            f"interleaving budget exceeded ({max_interleavings}); "
            "plan rejected unproven")
    return plan.proved


# ---------------------------------------------------------------------------
# np-rescaling forms (the scale harness's cross-size layer)

#: form kinds, in fitting priority order:
#: ("const", c)        peer = c at every (rank, np)
#: ("hiconst", k)      peer = np - 1 - k           (e.g. "last rank")
#: ("shift", s)        peer = (rank + s) mod np    (wrapped ring)
#: ("shiftwall", s)    peer = rank + s, wall (-1) outside [0, np)
#: ("block", a, d)     peer = (rank // a) * a + d  (island-of-a leader
#:                     offset d; island-relative const)
#: ("wall",)           peer = wall (-1 / None) everywhere
PEER_FORM_KINDS = ("const", "hiconst", "shift", "shiftwall", "block",
                   "wall")


def instantiate_peer(form: tuple, rank: int, np_: int,
                     wall: int = -1) -> Optional[int]:
    """Evaluate a fitted peer form at (rank, np)."""
    kind = form[0]
    if kind == "wall":
        return wall
    if kind == "const":
        return form[1]
    if kind == "hiconst":
        return np_ - 1 - form[1]
    if kind == "shift":
        return (rank + form[1]) % np_
    if kind == "shiftwall":
        p = rank + form[1]
        return p if 0 <= p < np_ else wall
    if kind == "block":
        return (rank // form[1]) * form[1] + form[2]
    raise ValueError(f"unknown peer form {form!r}")


def fit_peer_form(observations, *, block: Optional[int] = None,
                  wall: int = -1) -> Optional[tuple]:
    """Fit one affine-mod peer form to ``[(rank, np, peer), ...]``
    observations gathered at (at least two) calibration world sizes.

    ``peer`` may be the wall sentinel (negative) or None.  ``block``
    optionally offers an island size to try for island-relative forms
    (the caller scales it with np).  Returns the first form (in
    ``PEER_FORM_KINDS`` order) that reproduces *every* observation, or
    None — the caller then keeps the program concrete-only, which is
    the honest answer for peers that are not affine in rank."""
    obs = [(r, n, (wall if p is None or (isinstance(p, int) and p < 0)
                   else p))
           for r, n, p in observations]
    if not obs:
        return None

    def ok(form):
        return all(instantiate_peer(form, r, n, wall=wall) == p
                   for r, n, p in obs)

    if all(p == wall for _, _, p in obs):
        return ("wall",)
    if any(p == wall for _, _, p in obs):
        # mixed wall/peer: only the non-wrapping shift can produce it
        r0, n0, p0 = next(o for o in obs if o[2] != wall)
        form = ("shiftwall", p0 - r0)
        return form if ok(form) else None
    r0, n0, p0 = obs[0]
    candidates = [("const", p0), ("hiconst", n0 - 1 - p0)]
    for s_raw in (p0 - r0, p0 - r0 - n0, p0 - r0 + n0):
        candidates.append(("shift", s_raw))
        candidates.append(("shiftwall", s_raw))
    if block and block > 0:
        candidates.append(("block", block, p0 - (r0 // block) * block))
    for form in candidates:
        if ok(form):
            return form
    return None
