"""N-rank match simulation over extracted communication schedules.

A copy of ``mpi4jax_tpu/analysis/_match.py``.  Pure Python: given each rank's ordered :class:`CommEvent` list,
simulate the transport's matching rules and report everything that cannot
match.  The model mirrors ``native/tpucomm.cc``, from which the port's
transport is built too:

- point-to-point channels are per ``(comm, src, dst)`` FIFOs with strict
  in-order matching — a directed receive takes the channel *head* and a
  mismatched tag/dtype/size is a fail-fast program error, exactly like the
  native abort (a finding here, so analysis can continue past it);
- sends are buffered (the sender never blocks on the receiver in the
  native framing), receives block;
- ``ANY_SOURCE`` receives take the first *compatible* channel head, and
  may skip channels whose head doesn't match a concrete tag (the
  transport's wildcard scan does the same);
- collectives rendezvous: every member of the comm must arrive at a
  collective on that comm at the same per-comm position, and all arrived
  signatures must agree (kind, reduce op, root, dtype, shape).

On top of the faithful model sits one conservative pass the runtime cannot
perform: :func:`order_critical_findings` flags rank pairs whose raw
send/recv traffic forms a cycle — schedules that are only correct while
strict program order holds (ordering.py's deadlock-by-construction shape).
Reordering (a lost token edge, a future relaxed transport) deadlocks them,
so the verifier reports the hazard as a warning with both call sites.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ._events import (
    ANY_SOURCE,
    ANY_TAG,
    COLLECTIVE_KINDS,
    CommEvent,
    Finding,
    event_nbytes,
)

MAX_FINDINGS = 200

#: mirror of native/tpucomm.cc kEagerBytes: the floor of the progress
#: engine's detached-send threshold (detach_threshold() there is
#: max(32 KB, MPI4JAX_TPU_COALESCE_BYTES))
ENGINE_DETACH_FLOOR = 32 * 1024


def default_coalesce_bytes() -> int:
    """Resolved MPI4JAX_TPU_COALESCE_BYTES with the native parser's
    clamps (default 4096; 0 = off).  The ONE analysis-side reading of
    the knob — the detach threshold below and the plan compiler's
    coalesce marks both derive from it, so they cannot drift apart.

    Read from the environment directly (not utils.config) so the match
    model stays standalone-loadable, the same contract as the wildcard
    sentinels above; the knob is declared in ``config.KNOBS``."""
    raw = os.environ.get("MPI4JAX_TPU_COALESCE_BYTES", "").strip()
    if raw:
        try:
            return max(0, min(int(raw), 64 * 1024))
        except ValueError:
            pass  # the native parser rejects it loudly; keep the default
    return 4096


def default_detach_threshold() -> int:
    """Bytes up to which a send is truly buffered (detached) at run time.

    Mirrors the native engine's rules: with the async progress engine on
    (MPI4JAX_TPU_PROGRESS_THREAD, default on) sends up to
    max(32 KB, MPI4JAX_TPU_COALESCE_BYTES) copy their payload and return
    immediately, so they can never rendezvous-block.  With the engine
    off every send writes inline and the historic conservative model
    (any send may block) applies — threshold 0.
    """
    raw = os.environ.get("MPI4JAX_TPU_PROGRESS_THREAD", "").strip().lower()
    if raw in ("0", "false", "off", "no"):
        return 0
    return max(ENGINE_DETACH_FLOOR, default_coalesce_bytes())


def send_part_event(ev: CommEvent, dest: int) -> CommEvent:
    """The buffered-send half of ``ev`` toward ``dest``, exactly as the
    matcher pushes it onto the channel: a plain ``send`` is itself; the
    combined ops (``sendrecv``, ``shift2``) synthesize a send event
    carrying the op's send tag and payload signature.  The symbolic
    (rank-symmetry) layer re-synthesizes concrete findings through this
    same constructor, so its lifted findings are byte-identical to the
    concrete simulation's."""
    if ev.kind == "send":
        return ev
    tag = ev.sendtag if ev.kind == "sendrecv" else ev.tag
    return CommEvent(
        rank=ev.rank, idx=ev.idx, kind="send", comm=ev.comm,
        dest=dest, tag=tag, dtype=ev.dtype, shape=ev.shape, site=ev.site,
    )


def _site_pair(a: CommEvent, b: CommEvent) -> Tuple[str, ...]:
    return tuple(
        f"rank {e.rank}: {e.describe()}" for e in (a, b) if e is not None
    )


def compare_p2p(send: CommEvent, recv: CommEvent) -> List[Finding]:
    """Findings for a send/recv pair the channel model has matched."""
    found = []
    want_tag = recv.tag if recv.tag is not None else recv.recvtag
    have_tag = send.tag if send.tag is not None else send.sendtag
    if want_tag not in (None, ANY_TAG) and have_tag != want_tag:
        found.append(Finding(
            "tag_mismatch",
            f"rank {send.rank} sends tag {have_tag} but rank {recv.rank} "
            f"expects tag {want_tag}",
            ranks=(send.rank, recv.rank), comm=send.comm,
            sites=_site_pair(send, recv),
        ))
    if send.dtype and recv.dtype and send.dtype != recv.dtype:
        found.append(Finding(
            "dtype_mismatch",
            f"rank {send.rank} sends {send.dtype} but rank {recv.rank} "
            f"receives into {recv.dtype}",
            ranks=(send.rank, recv.rank), comm=send.comm,
            sites=_site_pair(send, recv),
        ))
    elif send.shape is not None and recv.shape is not None \
            and send.shape != recv.shape:
        if recv.status:
            # a Status-filling receive accepts SHORT messages (the
            # native recv_status contract: the actual byte count lands
            # in the Status); only truncation is a program error
            send_nb = event_nbytes(send.dtype, send.shape)
            recv_nb = event_nbytes(recv.dtype, recv.shape)
            if send_nb is not None and recv_nb is not None \
                    and send_nb <= recv_nb:
                return found
        found.append(Finding(
            "shape_mismatch",
            f"rank {send.rank} sends shape {send.shape} but rank "
            f"{recv.rank} receives into shape {recv.shape}",
            ranks=(send.rank, recv.rank), comm=send.comm,
            sites=_site_pair(send, recv),
        ))
    return found


def compare_collective(events: Sequence[CommEvent]) -> List[Finding]:
    """Findings for one collective rendezvous (one event per member)."""
    found = []
    ref = events[0]
    ref_sig = ref.collective_signature()
    for ev in events[1:]:
        sig = ev.collective_signature()
        if sig == ref_sig:
            continue
        if ev.kind != ref.kind:
            kind, msg = "collective_mismatch", (
                f"rank {ref.rank} runs {ref.kind} while rank {ev.rank} "
                f"runs {ev.kind} at the same program position"
            )
        elif ev.kind in ("allreduce", "reduce", "scan") \
                and ev.reduce_op != ref.reduce_op:
            kind, msg = "reduce_op_mismatch", (
                f"{ev.kind}: rank {ref.rank} uses {ref.reduce_op} while "
                f"rank {ev.rank} uses {ev.reduce_op}"
            )
        elif ev.root != ref.root:
            kind, msg = "root_mismatch", (
                f"{ev.kind}: rank {ref.rank} uses root {ref.root} while "
                f"rank {ev.rank} uses root {ev.root}"
            )
        elif ev.dtype != ref.dtype:
            kind, msg = "dtype_mismatch", (
                f"{ev.kind}: rank {ref.rank} contributes {ref.dtype} "
                f"while rank {ev.rank} contributes {ev.dtype}"
            )
        else:
            kind, msg = "shape_mismatch", (
                f"{ev.kind}: rank {ref.rank} contributes shape "
                f"{ref.shape} while rank {ev.rank} contributes shape "
                f"{ev.shape}"
            )
        found.append(Finding(kind, msg, ranks=(ref.rank, ev.rank),
                             comm=ref.comm, sites=_site_pair(ref, ev)))
    return found


def order_critical_findings(
    schedules: Dict[int, List[CommEvent]],
    comms: Dict[Tuple, Tuple[int, ...]] = None,
    detach_threshold: Optional[int] = None,
) -> List[Finding]:
    """Warn on cyclic raw send<->recv traffic between rank pairs.

    Fires when rank a both sends-to and receives-from rank b via separate
    ``send``/``recv`` calls (and b reciprocates): the match relies on every
    op executing exactly in program order.  Combined ``sendrecv``/
    ``shift2`` ops are exempt — they are the reorder-safe way to express
    the same exchange.

    Calibrated against the async progress engine's buffered sends: a
    send at or below ``detach_threshold`` bytes (default: the engine's
    detach threshold, see :func:`default_detach_threshold`) copies its
    payload and returns immediately, so an exchange whose sends on
    EITHER side all fit the threshold cannot rendezvous-block — the
    small side's send always completes, its recv then drains the peer,
    and the cycle is broken.  Only exchanges where both directions can
    actually block are flagged; unknown payload sizes stay conservative.
    """
    comms = comms or {}
    if detach_threshold is None:
        detach_threshold = default_detach_threshold()

    def can_block(send_ev: CommEvent) -> bool:
        nbytes = event_nbytes(send_ev.dtype, send_ev.shape)
        if nbytes is None:
            return True  # unknown payload: stay conservative
        return nbytes > detach_threshold

    def to_world(comm, local_rank):
        members = comms.get(comm)
        return local_rank if members is None else members[local_rank]

    sends: Dict[Tuple, CommEvent] = {}
    recvs: Dict[Tuple, CommEvent] = {}
    # whether ANY send on a direction can block: a small first send must
    # not mask a later above-threshold one on the same direction
    dir_blocks: Dict[Tuple, bool] = {}
    for rank, events in schedules.items():
        for ev in events:
            if ev.kind == "send":
                key = (ev.comm, rank, to_world(ev.comm, ev.dest))
                sends.setdefault(key, ev)
                dir_blocks[key] = dir_blocks.get(key) or can_block(ev)
            elif ev.kind == "recv" and ev.source != ANY_SOURCE:
                recvs.setdefault(
                    (ev.comm, rank, to_world(ev.comm, ev.source)), ev)
    found = []
    seen = set()
    ordered = sorted(
        sends.items(),
        key=lambda kv: (str(kv[0][0]), kv[1].rank, kv[1].idx),
    )
    for (comm, a, b), send_ab in ordered:
        key = (comm, frozenset((a, b)))
        if a == b or key in seen:
            continue
        recv_ab = recvs.get((comm, a, b))
        send_ba = sends.get((comm, b, a))
        recv_ba = recvs.get((comm, b, a))
        if recv_ab is None or send_ba is None or recv_ba is None:
            continue
        seen.add(key)
        if not (dir_blocks.get((comm, a, b))
                and dir_blocks.get((comm, b, a))):
            # EVERY send of at least one direction is a detached
            # buffered send at run time: that rank can never stall
            # before its recvs, so the exchange cannot deadlock under
            # any reordering
            continue
        found.append(Finding(
            "order_critical_exchange",
            f"ranks {a} and {b} exchange messages in both directions "
            "through separate send/recv calls, and both directions exceed "
            f"the buffered-send threshold ({detach_threshold} bytes): the "
            "schedule matches only under strict program-order execution "
            "(tokens/ordered effects intact); any reordering can "
            "rendezvous-block and deadlock. Prefer sendrecv() for "
            "bidirectional exchanges.",
            ranks=(a, b), comm=comm,
            sites=(
                f"rank {a}: {send_ab.describe()}",
                f"rank {a}: {recv_ab.describe()}",
                f"rank {b}: {send_ba.describe()}",
                f"rank {b}: {recv_ba.describe()}",
            ),
        ))
    return found


def wait_graph_findings(
    blocked: Dict[int, CommEvent],
    waits_on: Dict[int, Tuple[int, ...]],
    done: frozenset,
) -> List[Finding]:
    """Classify a stalled simulation: cycles among blocked ranks are
    deadlocks; waits on finished ranks are unmatched operations."""
    found = []
    # cycle detection over blocked ranks
    visiting, order = set(), []

    def _reach(r, path):
        if r in path:
            cycle = path[path.index(r):]
            return tuple(cycle)
        if r in visiting or r not in blocked:
            return None
        visiting.add(r)
        for peer in waits_on.get(r, ()):
            hit = _reach(peer, path + [r])
            if hit:
                return hit
        return None

    reported_cycles = set()
    for r in sorted(blocked):
        cyc = _reach(r, [])
        if cyc and frozenset(cyc) not in reported_cycles:
            reported_cycles.add(frozenset(cyc))
            arrow = " -> ".join(map(str, cyc + (cyc[0],)))
            found.append(Finding(
                "deadlock",
                f"cyclic wait: rank {arrow}; every rank in the cycle is "
                "blocked on a peer in the cycle",
                ranks=tuple(cyc),
                comm=blocked[cyc[0]].comm,
                sites=tuple(
                    f"rank {x}: {blocked[x].describe()}" for x in cyc
                ),
            ))
    in_cycle = set()
    for c in reported_cycles:
        in_cycle |= c
    for r in sorted(blocked):
        if r in in_cycle:
            continue
        ev = blocked[r]
        peers = waits_on.get(r, ())
        if ev.kind == "recv" and ev.source == ANY_SOURCE:
            found.append(Finding(
                "wildcard_starvation",
                f"rank {r} blocks on an ANY_SOURCE receive with no "
                "compatible send left on any channel",
                ranks=(r,), comm=ev.comm,
                sites=(f"rank {r}: {ev.describe()}",),
            ))
        elif ev.kind in COLLECTIVE_KINDS:
            missing = [p for p in peers]
            found.append(Finding(
                "collective_mismatch",
                f"rank {r} waits at {ev.kind} but rank(s) "
                f"{','.join(map(str, missing)) or '?'} never reach a "
                "collective on that communicator",
                ranks=(r,) + tuple(missing), comm=ev.comm,
                sites=(f"rank {r}: {ev.describe()}",),
            ))
        else:
            peer = peers[0] if peers else None
            state = "finished" if peer in done else "blocked elsewhere"
            found.append(Finding(
                "unmatched_recv" if ev.kind != "send" else "unmatched_send",
                f"rank {r} blocks on {ev.kind} from rank {peer}, which "
                f"{state} without a matching operation",
                ranks=(r,) + (() if peer is None else (peer,)),
                comm=ev.comm,
                sites=(f"rank {r}: {ev.describe()}",),
            ))
    return found


class _Channels:
    """Per (comm, src_local, dst_local) FIFO of buffered sends."""

    def __init__(self):
        self._q: Dict[Tuple, deque] = {}

    def push(self, comm, src, dst, event):
        self._q.setdefault((comm, src, dst), deque()).append(event)

    def head(self, comm, src, dst):
        q = self._q.get((comm, src, dst))
        return q[0] if q else None

    def pop(self, comm, src, dst):
        return self._q[(comm, src, dst)].popleft()

    def heads_for(self, comm, dst):
        """[(src, head_event)] over nonempty channels into ``dst``."""
        out = []
        for (c, s, d), q in sorted(self._q.items(),
                                   key=lambda kv: str(kv[0])):
            if c == comm and d == dst and q:
                out.append((s, q[0]))
        return out

    def leftovers(self):
        for (c, s, d), q in self._q.items():
            for ev in q:
                yield c, s, d, ev


def match_schedules(
    schedules: Dict[int, List[CommEvent]],
    comms: Dict[Tuple, Tuple[int, ...]],
    deliveries: Optional[dict] = None,
    service_order: Optional[Sequence[int]] = None,
    stats: Optional[dict] = None,
) -> List[Finding]:
    """Simulate matching of all rank schedules; return the findings.

    ``comms`` maps each comm key to its ordered world-rank member tuple
    (sub-rank i of the comm is world rank members[i]).

    ``deliveries``, when a dict is passed, is filled with the exact
    matching outcome — ``deliveries["p2p"][(comm, src, dst)]`` is the
    in-order list of ``(send_rank, send_idx, tag, recv_rank, recv_idx)``
    matches on that channel and ``deliveries["coll"][comm]`` the ordered
    collective rendezvous — so the schedule compiler's equivalence
    prover can assert a rewritten schedule delivers the same messages in
    the same per-channel order (payload content rides sends unchanged,
    so per-channel send identity ⇒ value identity).

    ``service_order`` overrides the deterministic rank-advance order
    (default: ascending) — the prover varies it to expose matches that
    depend on which rank the simulator happens to serve first
    (ANY_SOURCE races).

    ``stats``, when a dict is passed, receives ``{"steps": N}`` — the
    number of successful event completions the simulation performed
    (the scale harness charts this against the symbolic path's class-
    level step count).
    """
    findings: List[Finding] = []
    pcs = {r: 0 for r in schedules}
    chans = _Channels()
    if deliveries is not None:
        deliveries.setdefault("p2p", {})
        deliveries.setdefault("coll", {})

    def _rec_p2p(comm, src, dst, send_ev, recv_ev):
        if deliveries is None:
            return
        deliveries["p2p"].setdefault((comm, src, dst), []).append(
            (send_ev.rank, send_ev.idx, send_ev.tag,
             recv_ev.rank, recv_ev.idx)
        )

    def _rec_coll(comm, arrived):
        if deliveries is None:
            return
        deliveries["coll"].setdefault(comm, []).append(
            (arrived[0].kind,
             tuple(sorted((e.rank, e.idx) for e in arrived)))
        )
    total = sum(len(v) for v in schedules.values())
    for events in schedules.values():  # make reruns idempotent
        for ev in events:
            ev._sent = False

    def local(comm, world_rank):
        members = comms.get(comm)
        if members is None:
            return world_rank
        return members.index(world_rank)

    def world(comm, local_rank):
        members = comms.get(comm)
        if members is None:
            return local_rank
        return members[local_rank]

    def current(r):
        sched = schedules[r]
        return sched[pcs[r]] if pcs[r] < len(sched) else None

    def try_advance(r) -> bool:
        """Attempt to complete rank r's current event.  Returns True on
        progress (event completed or a send buffered)."""
        ev = current(r)
        if ev is None:
            return False
        me = local(ev.comm, r)
        if ev.kind == "send":
            chans.push(ev.comm, me, ev.dest, ev)
            pcs[r] += 1
            return True
        if ev.kind == "sendrecv":
            if not ev._sent:
                chans.push(ev.comm, me, ev.dest,
                           send_part_event(ev, ev.dest))
                ev._sent = True
            return _complete_recv(r, ev, me, ev.source, ev.recvtag)
        if ev.kind == "shift2":
            if not ev._sent:
                for peer in (ev.lo, ev.hi):
                    if peer is not None and peer >= 0:
                        chans.push(ev.comm, me, peer,
                                   send_part_event(ev, peer))
                ev._sent = True
            needed = [p for p in (ev.lo, ev.hi) if p is not None and p >= 0]
            if any(chans.head(ev.comm, p, me) is None for p in needed):
                return False
            for p in needed:
                sent = chans.pop(ev.comm, p, me)
                _rec_p2p(ev.comm, p, me, sent, ev)
                findings.extend(compare_p2p(sent, ev))
            pcs[r] += 1
            return True
        if ev.kind == "recv":
            return _complete_recv(r, ev, me, ev.source, ev.tag)
        if ev.kind in COLLECTIVE_KINDS:
            members = comms.get(ev.comm, tuple(sorted(schedules)))
            arrived = []
            for m in members:
                cur = current(m)
                if cur is None or cur.kind not in COLLECTIVE_KINDS \
                        or cur.comm != ev.comm:
                    return False
                arrived.append(cur)
            findings.extend(compare_collective(arrived))
            _rec_coll(ev.comm, arrived)
            for m in members:
                pcs[m] += 1
            return True
        return False  # unknown kind: skip defensively

    def _complete_recv(r, ev, me, source, tag) -> bool:
        if source == ANY_SOURCE:
            for src, head in chans.heads_for(ev.comm, me):
                head_tag = head.tag
                if tag in (None, ANY_TAG) or head_tag == tag:
                    sent = chans.pop(ev.comm, src, me)
                    _rec_p2p(ev.comm, src, me, sent, ev)
                    findings.extend(compare_p2p(sent, ev))
                    pcs[r] += 1
                    return True
            return False
        head = chans.head(ev.comm, source, me)
        if head is None:
            return False
        # strict in-order channel: the head is THE match; field
        # disagreements are findings (the native transport aborts here)
        sent = chans.pop(ev.comm, source, me)
        _rec_p2p(ev.comm, source, me, sent, ev)
        findings.extend(compare_p2p(sent, ev))
        pcs[r] += 1
        return True

    service = (list(service_order) if service_order is not None
               else sorted(schedules))
    steps = 0
    for _ in range(2 * total + 2):
        progressed = False
        for r in service:
            while try_advance(r):
                progressed = True
                steps += 1
                if stats is not None:
                    stats["steps"] = steps
                if len(findings) > MAX_FINDINGS:
                    findings.append(Finding(
                        "analysis_timeout",
                        f"more than {MAX_FINDINGS} findings; stopping",
                    ))
                    return findings
        if not progressed:
            break

    # ---- classify whatever could not complete -------------------------
    done = frozenset(r for r in schedules if current(r) is None)
    blocked = {r: current(r) for r in schedules if current(r) is not None}
    waits_on: Dict[int, Tuple[int, ...]] = {}
    for r, ev in blocked.items():
        if ev.kind in COLLECTIVE_KINDS:
            members = comms.get(ev.comm, tuple(sorted(schedules)))
            stragglers = []
            for m in members:
                cur = blocked.get(m)
                if m in done or (
                    cur is not None
                    and (cur.kind not in COLLECTIVE_KINDS
                         or cur.comm != ev.comm)
                ):
                    stragglers.append(m)
            waits_on[r] = tuple(stragglers)
        elif ev.kind in ("recv", "sendrecv"):
            if ev.source == ANY_SOURCE:
                members = comms.get(ev.comm, tuple(sorted(schedules)))
                waits_on[r] = tuple(m for m in members if m != r)
            else:
                waits_on[r] = (world(ev.comm, ev.source),)
        elif ev.kind == "shift2":
            needed = [p for p in (ev.lo, ev.hi) if p is not None and p >= 0]
            me = local(ev.comm, r)
            waits_on[r] = tuple(
                world(ev.comm, p) for p in needed
                if chans.head(ev.comm, p, me) is None
            )
        else:
            waits_on[r] = ()
    findings.extend(wait_graph_findings(blocked, waits_on, done))

    # ---- leftover buffered sends --------------------------------------
    consumed_pairs = set()
    for c, s, d, ev in chans.leftovers():
        dst_world = world(c, d)
        key = (c, s, d)
        if key in consumed_pairs:
            continue
        consumed_pairs.add(key)
        findings.append(Finding(
            "unmatched_send",
            f"rank {ev.rank} sends to rank {dst_world} (tag {ev.tag}) "
            "but no matching receive ever runs",
            ranks=(ev.rank, dst_world), comm=c,
            sites=(f"rank {ev.rank}: {ev.describe()}",),
        ))

    findings.extend(order_critical_findings(schedules, comms))
    return findings
