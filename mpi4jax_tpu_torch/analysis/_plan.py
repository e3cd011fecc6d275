"""Schedule compiler: verified execution plans over extracted schedules.

A copy of ``mpi4jax_tpu/analysis/_plan.py``: the same plans, JSON and
golden files.  The port does not execute plans yet (``runtime/planrt.py``
and ``launch --plan`` are queued in ROADMAP.md), so here a plan and a plan
bundle are data: compiled, proved, saved, loaded and diffed.

Schedule compilation à la GC3: the verifier extracts the exact per-rank
communication schedule, the transport offers the
execution substrate (detached buffered sends, per-peer coalescing,
pre-postable descriptors on the async progress engine) — this module
compiles the schedule into an :class:`ExecutionPlan` the runtime
(``runtime/planrt.py``) can execute with overlap:

- **concurrency groups** — consecutive, mutually-independent ops (per
  the ``_deps`` dependence DAG) whose completions may be outstanding
  together; the runner waits at the group boundary, not per op;
- **hoisted receives** — each eligible recv carries its earliest safe
  *post* point, so the progress engine reads the wire while the host is
  still computing (``post_at < idx`` in the plan);
- **coalescing marks** — adjacent small sends to one peer that the progress
  engine will merge into one wire frame;
- **gradient buckets** — runs of small same-op/dtype allreduces marked
  for fusion into bucketed allreduces (consumed by ``parallel.dp``).

Every plan is gated by an **equivalence prover** before anything may
execute it: the original and rewritten schedules both replay through the
match simulator (``_match.match_schedules``), with every
interleaving inside each concurrency group explored, and the plan is
rejected unless (a) no finding kind appears that the original schedule
did not produce, (b) the per-channel delivery order — and therefore the
delivered values, since payload content rides sends unchanged — is
identical, and (c) no interleaving can deadlock.  Programs whose
schedules carry true cross-rank ordering dependence (the recalibrated
``order_critical_exchange``) or statically-unresolvable control flow are
left unrewritten, with the reason recorded.

Import-light like ``_match``/``_deps``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import _deps, _match
from ._events import (
    ANALYZER_VERSION,
    COLLECTIVE_KINDS,
    CommEvent,
    Finding,
    event_nbytes,
    schedule_cache_key,
)

#: plan wire-format version (bumped with ANALYZER_VERSION on semantic
#: changes; loaders reject mismatches instead of misreading)
PLAN_FORMAT = 1

#: default gradient-bucket ceiling; MPI4JAX_TPU_PLAN_BUCKET_KB overrides
DEFAULT_BUCKET_BYTES = 1 << 20

#: equivalence-prover budget: total simulations across the base run, the
#: per-group interleavings, and the reversed config
MAX_INTERLEAVINGS = 256

#: finding kinds that make a schedule unplannable — the static schedule
#: is not the (only) runtime schedule, so no rewrite can be proven
UNPLANNABLE_KINDS = frozenset({
    "control_divergence", "comm_in_while", "token_violation",
    "analysis_timeout", "rank_error",
})


#: one analysis-side reading of the coalesce knob (native-clamp mirror)
default_coalesce_bytes = _match.default_coalesce_bytes


def default_bucket_bytes() -> int:
    raw = os.environ.get("MPI4JAX_TPU_PLAN_BUCKET_KB", "").strip()
    if raw:
        try:
            return max(0, int(raw)) * 1024
        except ValueError:
            # same strictness as utils.config.plan_bucket_bytes: a
            # typo'd knob must not silently change the plan's buckets
            raise ValueError(
                f"cannot parse MPI4JAX_TPU_PLAN_BUCKET_KB={raw!r} as KB")
    return DEFAULT_BUCKET_BYTES


def env_cost_model():
    """The cost model named by ``MPI4JAX_TPU_TUNE_MODEL`` (written by
    ``python -m mpi4jax_tpu_torch.tune --joint``), or None.  The compiler
    only probes the disk when the knob is set explicitly, so plans —
    and the golden-plan corpus — compiled without it are byte-stable
    regardless of what a previous tuner run left in ``~/.cache``."""
    path = os.environ.get("MPI4JAX_TPU_TUNE_MODEL", "").strip()
    if not path:
        return None
    try:
        try:
            from ..tune import _model
        except ImportError:  # standalone analysis load (no package)
            import importlib.util

            spec = importlib.util.spec_from_file_location(
                "m4j_plan_cost_model",
                os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             os.pardir, "tune", "_model.py"))
            _model = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(_model)
        return _model.load_model(path)
    except Exception as e:
        # warn-and-continue is the contract: an unusable model file —
        # unreadable, wrong version, OR structurally corrupt (a shape
        # from_json never anticipated) — must never take down plan
        # compilation; the static defaults serve
        import warnings

        warnings.warn(f"ignoring unusable cost model "
                      f"MPI4JAX_TPU_TUNE_MODEL={path}: {e!r}")
        return None


def _model_bucket_bytes(events_by_rank, model) -> Optional[int]:
    """The cost model's gradient-bucket ceiling for THIS schedule: the
    ceiling minimizing the predicted cost of syncing the schedule's
    bucketable allreduce bytes (the dominant rank's total).  None when
    the schedule has nothing to bucket or the model no allreduce data —
    the static default then stands."""
    ladder_max = max(_TUNE_BUCKET_LADDER)
    total = 0
    for events in events_by_rank.values():
        rank_total = sum(
            ev.nbytes or 0 for ev in events
            if ev.kind == "allreduce" and ev.nbytes
            and ev.nbytes <= ladder_max)
        total = max(total, rank_total)
    if total <= 0:
        return None
    return model.best_bucket_bytes(total, ladder=_TUNE_BUCKET_LADDER)


def _model_group_cap(events_by_rank, model) -> Optional[int]:
    """The cost model's concurrency-group cap: keyed on the schedule's
    median deferrable-send payload, using the measured allreduce curve
    as the transport proxy (sends are not swept per-algorithm — the
    collective alpha/beta is the same wire).  None without send events
    or model data."""
    sends = sorted(ev.nbytes for events in events_by_rank.values()
                   for ev in events
                   if ev.kind == "send" and ev.nbytes)
    if not sends:
        return None
    median = sends[len(sends) // 2]
    combos = model.combos("allreduce")
    if not combos:
        return None
    combo = "ring" if "ring" in combos else combos[0]
    cap = model.suggested_group_cap(median, op="allreduce", combo=combo,
                                    default=_deps.MAX_GROUP)
    return cap if cap != _deps.MAX_GROUP else None


#: bucket-size candidates the model evaluates (mirrors
#: tune._model.BUCKET_LADDER without importing it on the hot path)
_TUNE_BUCKET_LADDER = tuple(1 << p for p in range(16, 23))


@dataclass
class PlanOp:
    """One scheduled op in one rank's execution plan.

    ``idx`` is the op's position in the original (token-order) schedule;
    ``group`` its concurrency group; ``post_at`` the position the op is
    *posted* at (< idx only for hoisted receives); ``deferred`` marks
    ops whose completion wait moves to the group boundary (sends);
    ``coalesce`` marks members of a small-send run the engine merges;
    ``bucket`` is the gradient-bucket id, or None.
    """

    idx: int
    kind: str
    comm: Tuple = (0,)
    dest: Optional[int] = None
    source: Optional[int] = None
    lo: Optional[int] = None
    hi: Optional[int] = None
    root: Optional[int] = None
    tag: Optional[int] = None
    sendtag: Optional[int] = None
    recvtag: Optional[int] = None
    reduce_op: Optional[str] = None
    dtype: Optional[str] = None
    shape: Optional[Tuple[int, ...]] = None
    status: bool = False
    nbytes: Optional[int] = None
    group: int = 0
    post_at: int = 0
    deferred: bool = False
    coalesce: bool = False
    bucket: Optional[int] = None

    @classmethod
    def from_event(cls, ev: CommEvent) -> "PlanOp":
        return cls(
            idx=ev.idx, kind=ev.kind, comm=tuple(ev.comm), dest=ev.dest,
            source=ev.source, lo=ev.lo, hi=ev.hi, root=ev.root, tag=ev.tag,
            sendtag=ev.sendtag, recvtag=ev.recvtag, reduce_op=ev.reduce_op,
            dtype=ev.dtype,
            shape=None if ev.shape is None else tuple(ev.shape),
            status=bool(ev.status),
            nbytes=event_nbytes(ev.dtype, ev.shape),
            post_at=ev.idx,
        )

    @property
    def hoisted(self) -> bool:
        return self.post_at < self.idx

    def describe(self) -> str:
        bits = [self.kind]
        if self.kind == "send":
            bits.append(f"to {self.dest} tag {self.tag}")
        elif self.kind == "recv":
            bits.append(f"from {self.source} tag {self.tag}")
        elif self.kind == "sendrecv":
            bits.append(f"to {self.dest} from {self.source}")
        elif self.kind == "shift2":
            bits.append(f"lo {self.lo} hi {self.hi}")
        elif self.root is not None:
            bits.append(f"root {self.root}")
        if self.reduce_op:
            bits.append(f"op {self.reduce_op}")
        if self.dtype:
            shape = "x".join(map(str, self.shape or ()))
            bits.append(f"{self.dtype}[{shape}]")
        marks = []
        if self.hoisted:
            marks.append(f"post@{self.post_at}")
        if self.deferred:
            marks.append("deferred")
        if self.coalesce:
            marks.append("coalesce")
        if self.bucket is not None:
            marks.append(f"bucket {self.bucket}")
        if marks:
            bits.append("(" + ", ".join(marks) + ")")
        return " ".join(bits)

    def to_json(self) -> dict:
        out = {"idx": self.idx, "kind": self.kind, "comm": list(self.comm),
               "group": self.group, "post_at": self.post_at}
        for name in ("dest", "source", "lo", "hi", "root", "tag",
                     "sendtag", "recvtag", "reduce_op", "dtype", "nbytes",
                     "bucket"):
            v = getattr(self, name)
            if v is not None:
                out[name] = v
        if self.shape is not None:
            out["shape"] = list(self.shape)
        for flag in ("status", "deferred", "coalesce"):
            if getattr(self, flag):
                out[flag] = True
        return out

    @classmethod
    def from_json(cls, data: dict) -> "PlanOp":
        kw = dict(data)
        kw["comm"] = tuple(kw.get("comm", (0,)))
        if kw.get("shape") is not None:
            kw["shape"] = tuple(kw["shape"])
        return cls(**kw)


@dataclass
class RankPlan:
    rank: int
    ops: List[PlanOp] = field(default_factory=list)
    groups: List[List[int]] = field(default_factory=list)

    @property
    def n_hoisted(self) -> int:
        return sum(1 for op in self.ops if op.hoisted)

    @property
    def n_deferred(self) -> int:
        return sum(1 for op in self.ops if op.deferred)

    @property
    def n_grouped(self) -> int:
        return sum(len(g) for g in self.groups if len(g) > 1)

    def to_json(self) -> dict:
        return {"rank": self.rank,
                "ops": [op.to_json() for op in self.ops],
                "groups": [list(g) for g in self.groups]}

    @classmethod
    def from_json(cls, data: dict) -> "RankPlan":
        return cls(rank=int(data["rank"]),
                   ops=[PlanOp.from_json(o) for o in data["ops"]],
                   groups=[list(g) for g in data.get("groups", [])])


@dataclass
class ExecutionPlan:
    """A verified (or verifiably rejected) whole-program execution plan."""

    world_size: int
    cache_key: str = ""
    analyzer_version: str = ANALYZER_VERSION
    detach_threshold: int = 0
    coalesce_bytes: int = 0
    bucket_bytes: int = 0
    #: provenance of model-informed choices ("" = static defaults; the
    #: golden corpus compiles without a model, so the field stays absent
    #: there)
    model: str = ""
    ranks: Dict[int, RankPlan] = field(default_factory=dict)
    proved: bool = False
    proof: dict = field(default_factory=dict)
    reasons: List[str] = field(default_factory=list)

    @property
    def rewritten(self) -> bool:
        """True when the plan changes anything relative to token order."""
        return any(
            rp.n_hoisted or rp.n_grouped or rp.n_deferred
            or any(op.bucket is not None or op.coalesce for op in rp.ops)
            for rp in self.ranks.values()
        )

    def summary(self) -> str:
        hoisted = sum(rp.n_hoisted for rp in self.ranks.values())
        deferred = sum(rp.n_deferred for rp in self.ranks.values())
        grouped = sum(rp.n_grouped for rp in self.ranks.values())
        buckets = len({(r, op.bucket) for r, rp in self.ranks.items()
                       for op in rp.ops if op.bucket is not None})
        coalesce = sum(1 for rp in self.ranks.values()
                       for op in rp.ops if op.coalesce)
        verdict = "proved" if self.proved else "NOT PROVED"
        state = "rewritten" if self.rewritten else "unrewritten"
        return (f"plan {self.cache_key or '?'} np={self.world_size}: "
                f"{state}, {verdict} "
                f"({self.proof.get('interleavings', 0)} interleavings); "
                f"{hoisted} hoisted recv(s), {grouped} grouped op(s), "
                f"{deferred} deferred send(s), {coalesce} coalesce "
                f"mark(s), {buckets} bucket(s)")

    def format(self) -> str:
        lines = [self.summary()]
        for reason in self.reasons:
            lines.append(f"  note: {reason}")
        for rank in sorted(self.ranks):
            rp = self.ranks[rank]
            lines.append(f"-- rank {rank}: {len(rp.ops)} op(s), "
                         f"{len(rp.groups)} group(s) --")
            for op in rp.ops:
                lines.append(f"   g{op.group:<3d}[{op.idx}] {op.describe()}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        out = {
            "format": PLAN_FORMAT,
            "analyzer_version": self.analyzer_version,
            "cache_key": self.cache_key,
            "world_size": self.world_size,
            "detach_threshold": self.detach_threshold,
            "coalesce_bytes": self.coalesce_bytes,
            "bucket_bytes": self.bucket_bytes,
            "proved": self.proved,
            "rewritten": self.rewritten,  # derived; for JSON consumers
            "proof": self.proof,
            "reasons": list(self.reasons),
            "ranks": {str(r): rp.to_json()
                      for r, rp in sorted(self.ranks.items())},
        }
        if self.model:
            out["model"] = self.model
        return out

    @classmethod
    def from_json(cls, data: dict) -> "ExecutionPlan":
        if data.get("format") != PLAN_FORMAT:
            raise ValueError(
                f"plan format {data.get('format')!r} is not {PLAN_FORMAT}"
            )
        plan = cls(
            world_size=int(data["world_size"]),
            cache_key=data.get("cache_key", ""),
            analyzer_version=data.get("analyzer_version", ""),
            detach_threshold=int(data.get("detach_threshold", 0)),
            coalesce_bytes=int(data.get("coalesce_bytes", 0)),
            bucket_bytes=int(data.get("bucket_bytes", 0)),
            model=str(data.get("model", "")),
            proved=bool(data.get("proved", False)),
            proof=dict(data.get("proof", {})),
            reasons=list(data.get("reasons", [])),
        )
        for r, rp in data.get("ranks", {}).items():
            plan.ranks[int(r)] = RankPlan.from_json(rp)
        return plan


def diff_plans(a: ExecutionPlan, b: ExecutionPlan,
               a_name: str = "expected", b_name: str = "actual") -> str:
    """Unified diff of two plans' canonical JSON (empty = identical).

    Proof statistics are excluded: the *schedule rewrite* is the golden
    contract, prover timing/budget details are not.
    """
    import difflib

    def canon(p: ExecutionPlan) -> List[str]:
        data = p.to_json()
        data.pop("proof", None)
        return json.dumps(data, indent=1, sort_keys=True).splitlines()

    return "\n".join(difflib.unified_diff(
        canon(a), canon(b), fromfile=a_name, tofile=b_name, lineterm=""))


# ---------------------------------------------------------------------------
# plan construction


def _mark_coalesce(ops: List[PlanOp], coalesce_bytes: int) -> None:
    run: List[int] = []

    def flush():
        if len(run) >= 2:
            for i in run:
                ops[i].coalesce = True
        run.clear()

    prev_key = None
    for i, op in enumerate(ops):
        key = None
        if (op.kind == "send" and op.nbytes is not None
                and coalesce_bytes > 0 and op.nbytes <= coalesce_bytes):
            key = (op.comm, op.dest)
        if key is None or key != prev_key:
            flush()
        if key is not None:
            run.append(i)
        prev_key = key
    flush()


def _mark_buckets(ops: List[PlanOp], bucket_bytes: int) -> None:
    if bucket_bytes <= 0:
        return
    next_bucket = 0
    run: List[int] = []

    def flush():
        nonlocal next_bucket
        if len(run) >= 2:
            for i in run:
                ops[i].bucket = next_bucket
            next_bucket += 1
        run.clear()

    prev_key = None
    filled = 0
    for i, op in enumerate(ops):
        key = None
        if (op.kind == "allreduce" and op.nbytes is not None
                and op.nbytes <= bucket_bytes):
            key = (op.comm, op.reduce_op, op.dtype)
        if key is None or key != prev_key or filled + (op.nbytes or 0) > \
                bucket_bytes:
            flush()
            filled = 0
        if key is not None:
            run.append(i)
            filled += op.nbytes or 0
        prev_key = key
    flush()


def build_plan(
    events_by_rank: Dict[int, List[CommEvent]],
    comms: Dict[Tuple, Tuple[int, ...]],
    *,
    world_size: Optional[int] = None,
    findings: Sequence[Finding] = (),
    value_deps_by_rank: Optional[Dict[int, set]] = None,
    detach_threshold: Optional[int] = None,
    coalesce_bytes: Optional[int] = None,
    bucket_bytes: Optional[int] = None,
    max_group: int = _deps.MAX_GROUP,
    aggressive: bool = True,
    force_trivial: bool = False,
    cost_model=None,
) -> ExecutionPlan:
    """Compile per-rank schedules into an (unproven) execution plan.

    ``findings`` is the verification report's finding list: error-level
    findings and statically-unresolvable schedules (control divergence,
    comm-in-while, token violations) make the program unplannable, and a
    recalibrated ``order_critical_exchange`` — true cross-rank ordering
    dependence — leaves the schedule unrewritten (trivial plan).

    ``aggressive=False`` builds the fallback plan: groups and marks but
    no recv hoisting (used when the prover rejects the hoisted plan).

    ``cost_model`` (a ``tune._model.CostModel``; default: the file
    ``MPI4JAX_TPU_TUNE_MODEL`` names, if any) informs the two sizing
    choices the compiler otherwise makes statically: the
    gradient-bucket ceiling (the predicted-cheapest point of the bucket
    ladder for this schedule's bucketable bytes — an EXPLICIT
    ``MPI4JAX_TPU_PLAN_BUCKET_KB`` still wins) and the concurrency-
    group cap (deeper groups where the measured curve says dispatch
    dominates).  The plan records the provenance (``model`` field).
    """
    if world_size is None:
        world_size = len(events_by_rank)
    if detach_threshold is None:
        detach_threshold = _match.default_detach_threshold()
    if coalesce_bytes is None:
        coalesce_bytes = default_coalesce_bytes()
    if cost_model is None:
        cost_model = env_cost_model()
    model_notes = []
    if bucket_bytes is None:
        bucket_bytes = default_bucket_bytes()
        if (cost_model is not None
                and not os.environ.get("MPI4JAX_TPU_PLAN_BUCKET_KB",
                                       "").strip()):
            picked = _model_bucket_bytes(events_by_rank, cost_model)
            if picked is not None and picked != bucket_bytes:
                model_notes.append(
                    f"bucket_bytes {picked} (model; static default "
                    f"{bucket_bytes})")
                bucket_bytes = picked
    if cost_model is not None and max_group == _deps.MAX_GROUP:
        cap = _model_group_cap(events_by_rank, cost_model)
        if cap is not None:
            model_notes.append(
                f"group cap {cap} (model; static default {max_group})")
            max_group = cap
    plan = ExecutionPlan(
        world_size=world_size,
        cache_key=schedule_cache_key(events_by_rank, world_size),
        detach_threshold=detach_threshold,
        coalesce_bytes=coalesce_bytes,
        bucket_bytes=bucket_bytes,
    )
    if model_notes:
        plan.model = "; ".join(model_notes)
        plan.reasons.append("cost model consulted: " + plan.model)

    blockers = sorted(
        {f.kind for f in findings
         if f.severity == "error" or f.kind in UNPLANNABLE_KINDS}
    )
    pinned = any(f.kind == "order_critical_exchange" for f in findings)
    # the runtime runner serves the WORLD communicator only: a schedule
    # that communicates on sub-comms would desync its cursor (sub-comm
    # ops bypass the world runner), so such programs stay unrewritten
    world_key = (0,)
    subcomms = any(
        tuple(ev.comm) != world_key
        for events in events_by_rank.values() for ev in events
    )
    trivial = bool(blockers) or pinned or subcomms or force_trivial
    if blockers:
        plan.reasons.append(
            "unplannable schedule: " + ", ".join(blockers)
        )
    if pinned:
        plan.reasons.append(
            "order-critical exchange: true cross-rank ordering "
            "dependence — schedule left unrewritten"
        )
    if subcomms and not (blockers or pinned or force_trivial):
        plan.reasons.append(
            "sub-communicator schedule: plan execution serves the "
            "world communicator only — schedule left unrewritten"
        )

    for rank, events in sorted(events_by_rank.items()):
        ops = [PlanOp.from_event(ev) for ev in events]
        for pos, op in enumerate(ops):
            # positions are the plan's coordinate system; re-number so a
            # truncated/merged extraction cannot desync the groups
            op.idx = pos
            op.post_at = pos
        if trivial:
            groups = [[i] for i in range(len(ops))]
        else:
            vdeps = (value_deps_by_rank or {}).get(rank)
            deps = _deps.build_rank_deps(events, value_deps=vdeps)
            groups = _deps.concurrency_groups(events, deps,
                                              max_group=max_group)
            # never hoist on a channel that ANYWHERE in the schedule
            # also carries a Status or wildcard receive: a pre-posted
            # strict descriptor owns the next wire message on its
            # channel, and mixing it with flexible receives is exactly
            # the reconciliation the runtime fallback cannot do safely
            wild_comms = set()
            status_channels = set()
            for ev in events:
                if ev.source == _deps.ANY_SOURCE:
                    wild_comms.add(ev.comm)
                elif ev.status and ev.kind in ("recv", "sendrecv"):
                    status_channels.add((ev.comm, ev.source))
            for pos, op in enumerate(ops):
                if op.kind == "send":
                    op.deferred = True
                if (aggressive and op.kind == "recv"
                        and op.comm not in wild_comms
                        and (op.comm, op.source) not in status_channels):
                    op.post_at = _deps.recv_post_point(events, deps, pos)
            _mark_coalesce(ops, min(coalesce_bytes, detach_threshold))
            _mark_buckets(ops, bucket_bytes)
        for gid, members in enumerate(groups):
            for pos in members:
                ops[pos].group = gid
        plan.ranks[rank] = RankPlan(rank=rank, ops=ops, groups=groups)
    return plan


# ---------------------------------------------------------------------------
# equivalence prover


def _planned_order(events: List[CommEvent], rp: RankPlan) -> List[int]:
    """Positions of ``events`` in planned wire order.

    A hoisted recv (``post_at = p < idx``) is posted immediately after
    op ``p``'s own post, so its wire slot sits between ``p`` and
    ``p + 1``; the FIFO progress engine makes post order the wire order.
    For the common temporal hoist (``p == idx - 1``) the order is
    unchanged — only the *time* of the post moves earlier, into the
    host-compute gap.  Multiple hoists to one point keep their original
    relative order."""
    keys = []
    for pos in range(len(events)):
        op = rp.ops[pos]
        if op.hoisted:
            keys.append((op.post_at + 0.5, pos))
        else:
            keys.append((float(pos), pos))
    return [pos for _, pos in sorted(keys)]


def _apply_perm(order: List[int], members: List[int],
                perm: Tuple[int, ...]) -> List[int]:
    """Reorder ``members`` (original positions) within ``order`` slots."""
    slots = [order.index(m) for m in members]
    out = list(order)
    for slot, m in zip(sorted(slots), perm):
        out[slot] = m
    return out


def _simulate(events_by_rank, comms, orders,
              service_order=None) -> Tuple[set, dict]:
    schedules = {
        r: [events_by_rank[r][pos] for pos in orders[r]]
        for r in events_by_rank
    }
    deliv: dict = {}
    findings = _match.match_schedules(schedules, comms, deliveries=deliv,
                                      service_order=service_order)
    return {f.kind for f in findings}, deliv


def _group_interleavings(events, members: List[int]) -> List[Tuple[int, ...]]:
    """Every completion order a concurrency group can exhibit at run
    time.  The FIFO progress engine pins the relative wire order of
    same-engine members to post order, so the realizable orders are the
    riffles of the per-engine-root subsequences (identity excluded).

    NOTE: today ``build_plan`` leaves sub-communicator schedules
    unrewritten, so every compilable plan's events share one engine
    root and this returns [] — the realizable set is the singleton post
    order, and the proof reduces to planned order + rank-service
    rotations.  The riffle machinery is the contract a future
    multi-engine (or out-of-order-engine) planner must re-enter, and
    the unit tests pin it with hand-built foreign-engine events."""
    by_root: Dict[Tuple, List[int]] = {}
    for m in members:
        by_root.setdefault(_deps._engine_root(events[m].comm), []).append(m)
    seqs = list(by_root.values())
    if len(seqs) == 1:
        return []  # one engine: post order IS the only realizable order

    def riffle(parts: List[List[int]]):
        if all(not p for p in parts):
            yield ()
            return
        for i, p in enumerate(parts):
            if not p:
                continue
            rest = [list(q) for q in parts]
            head = rest[i].pop(0)
            for tail in riffle(rest):
                yield (head,) + tail

    return [perm for perm in riffle([list(s) for s in seqs])
            if list(perm) != members]


def prove_plan(
    events_by_rank: Dict[int, List[CommEvent]],
    comms: Dict[Tuple, Tuple[int, ...]],
    plan: ExecutionPlan,
    max_interleavings: int = MAX_INTERLEAVINGS,
    symmetry=None,
) -> bool:
    """Replay original and planned schedules through the match simulator.

    Configurations explored:

    - the planned wire order itself (hoists applied);
    - for every concurrency group, every completion order the execution
      substrate can realize (the FIFO progress engine pins same-engine
      members to post order; members on different engine roots riffle
      freely), with all other groups at planned order;
    - every rotation of the simulator's rank-service order, which
      exposes matches that depend on which rank happens to progress
      first (ANY_SOURCE races).

    The plan is accepted only if every replay (a) produces no finding
    kind the original schedule did not, and (b) delivers the same
    messages in the same per-channel order — which pins delivered
    values, since payload content rides sends unchanged.  A replay that
    stalls shows up as (a): deadlock/unmatched kinds.  Sets
    ``plan.proved`` and ``plan.proof``.

    ``symmetry`` (a ``_symbolic.SymmetryPartition``) quotients the
    proof: one replay per class-level configuration, with rank-service
    rotations collapsed to class-service rotations — the step that
    keeps the budget independent of np (512 concrete rotations exceed
    ``MAX_INTERLEAVINGS``; the quotient needs one per class).  A plan
    outside the symbolic model silently falls back to the concrete
    proof below, which stays sound at any size (at worst: budget
    exceeded, plan rejected unproven).
    """
    if symmetry is not None:
        from . import _symbolic

        try:
            verdict = _symbolic.prove_plan_symbolic(
                events_by_rank, comms, plan, symmetry,
                max_interleavings=max_interleavings)
        except (_symbolic.Uncanonicalizable, _symbolic.FallbackNeeded):
            verdict = None
        if verdict is not None:
            return verdict
    ranks = sorted(events_by_rank)
    base_orders = {r: list(range(len(v)))
                   for r, v in events_by_rank.items()}
    base_kinds, base_deliv = _simulate(events_by_rank, comms, base_orders)
    planned = {r: _planned_order(events_by_rank[r], plan.ranks[r])
               for r in events_by_rank}

    # (orders, service_order) configurations
    configs: List[Tuple[Dict[int, List[int]], Optional[List[int]]]] = [
        (planned, None)
    ]
    for rank in ranks:
        rp = plan.ranks[rank]
        for members in rp.groups:
            if len(members) < 2:
                continue
            for perm in _group_interleavings(events_by_rank[rank],
                                             members):
                orders = dict(planned)
                orders[rank] = _apply_perm(planned[rank], members, perm)
                configs.append((orders, None))
    for shift in range(1, len(ranks)):
        rotated = ranks[shift:] + ranks[:shift]
        configs.append((planned, rotated))

    exhaustive = len(configs) <= max_interleavings
    if not exhaustive:
        configs = configs[:max_interleavings]

    failures: List[str] = []
    for i, (orders, service) in enumerate(configs):
        kinds, deliv = _simulate(events_by_rank, comms, orders,
                                 service_order=service)
        new_kinds = kinds - base_kinds
        if new_kinds:
            failures.append(
                f"interleaving {i}: new finding kind(s) "
                f"{sorted(new_kinds)}"
            )
        elif deliv != base_deliv:
            failures.append(
                f"interleaving {i}: per-channel delivery order changed"
            )
        if failures:
            break

    plan.proof = {
        "interleavings": len(configs),
        "exhaustive": exhaustive,
        "base_finding_kinds": sorted(base_kinds),
        "failures": failures,
    }
    plan.proved = not failures and exhaustive
    if failures:
        plan.reasons.extend(failures)
    elif not exhaustive:
        plan.reasons.append(
            f"interleaving budget exceeded ({max_interleavings}); "
            "plan rejected unproven"
        )
    return plan.proved


def compile_schedules(
    events_by_rank: Dict[int, List[CommEvent]],
    comms: Dict[Tuple, Tuple[int, ...]],
    *,
    findings: Sequence[Finding] = (),
    world_size: Optional[int] = None,
    value_deps_by_rank: Optional[Dict[int, set]] = None,
    detach_threshold: Optional[int] = None,
    coalesce_bytes: Optional[int] = None,
    bucket_bytes: Optional[int] = None,
    max_interleavings: int = MAX_INTERLEAVINGS,
    cost_model=None,
    symmetry=None,
) -> ExecutionPlan:
    """Build the most aggressive provable plan: try hoisting + grouping,
    fall back to no-hoist, then to the trivial (unrewritten) plan.  The
    returned plan always carries ``proved`` and the downgrade reasons —
    an unsafe rewrite is *demonstrably* rejected, never silently run.

    ``symmetry`` (a ``_symbolic.SymmetryPartition``) is forwarded to
    the equivalence prover; see :func:`prove_plan`."""
    if cost_model is None:
        # resolve the env-named model once for all three attempts
        cost_model = env_cost_model()
    kw = dict(
        world_size=world_size, findings=findings,
        value_deps_by_rank=value_deps_by_rank,
        detach_threshold=detach_threshold, coalesce_bytes=coalesce_bytes,
        bucket_bytes=bucket_bytes, cost_model=cost_model,
    )
    plan = build_plan(events_by_rank, comms, aggressive=True, **kw)
    if prove_plan(events_by_rank, comms, plan, max_interleavings,
                  symmetry=symmetry):
        return plan
    rejected_reasons = list(plan.reasons)

    fallback = build_plan(events_by_rank, comms, aggressive=False, **kw)
    fallback.reasons = rejected_reasons + [
        "hoisted plan rejected by the equivalence prover; "
        "retrying without recv hoisting"
    ]
    if prove_plan(events_by_rank, comms, fallback, max_interleavings,
                  symmetry=symmetry):
        fallback.reasons = [r for r in fallback.reasons
                            if not r.startswith("interleaving ")]
        return fallback

    trivial = build_plan(events_by_rank, comms, aggressive=False,
                         force_trivial=True, **kw)
    trivial.reasons = [
        "grouped plan rejected by the equivalence prover; "
        "schedule left unrewritten"
    ]
    prove_plan(events_by_rank, comms, trivial, max_interleavings,
               symmetry=symmetry)
    return trivial


# ---------------------------------------------------------------------------
# plan cache (per schedule hash)


def plan_cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "mpi4jax_tpu_torch", "plans")


def plan_cache_path(cache_key: str) -> str:
    return os.path.join(plan_cache_dir(), f"{cache_key}.json")


def save_plan(plan: ExecutionPlan, path: Optional[str] = None) -> str:
    path = path or plan_cache_path(plan.cache_key)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(plan.to_json(), f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def _plan_from_data(data: dict, path: str) -> ExecutionPlan:
    plan = ExecutionPlan.from_json(data)
    if plan.analyzer_version != ANALYZER_VERSION:
        raise ValueError(
            f"plan at {path} was compiled by analyzer "
            f"{plan.analyzer_version!r}, this is {ANALYZER_VERSION!r} — "
            "recompile (the cache key embeds the version exactly so "
            "stale plans invalidate instead of misexecuting)"
        )
    return plan


def load_plan(path: str) -> ExecutionPlan:
    with open(path) as f:
        data = json.load(f)
    return _plan_from_data(data, path)


def cached_plan(cache_key: str) -> Optional[ExecutionPlan]:
    """The cached verified plan for a schedule hash, or None (missing,
    unreadable, version-mismatched, or never proved)."""
    path = plan_cache_path(cache_key)
    try:
        plan = load_plan(path)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
    if plan.cache_key != cache_key or not plan.proved:
        return None
    return plan


# ---------------------------------------------------------------------------
# elastic-safe plans: bundles (one plan per survivable world size) and
# in-recovery re-derivation


def events_from_plan(plan: ExecutionPlan):
    """Reconstruct the per-rank schedules a plan was compiled from:
    ``(events_by_rank, comms)`` ready for :func:`compile_schedules`.

    A :class:`PlanOp` carries every field of the event's *semantic
    identity* (``_events.canonical_event`` — exactly what the schedule
    cache key hashes), so the reconstruction round-trips the cache key
    bit-for-bit; only presentation (source-site strings) is lost.  This
    is what lets elastic recovery re-derive and re-PROVE a stored plan
    from the plan file alone, with no program re-trace."""
    events_by_rank: Dict[int, List[CommEvent]] = {}
    for rank, rp in sorted(plan.ranks.items()):
        events_by_rank[rank] = [
            CommEvent(
                rank=rank, idx=i, kind=op.kind, comm=tuple(op.comm),
                dest=op.dest, source=op.source, lo=op.lo, hi=op.hi,
                root=op.root, tag=op.tag, sendtag=op.sendtag,
                recvtag=op.recvtag, reduce_op=op.reduce_op,
                dtype=op.dtype,
                shape=None if op.shape is None else tuple(op.shape),
                status=bool(op.status),
            )
            for i, op in enumerate(rp.ops)
        ]
    # compilable plans serve the world communicator only (build_plan
    # leaves sub-comm schedules unrewritten; planrt.install refuses
    # them), so the comm map is exactly the world membership
    comms = {(0,): tuple(sorted(plan.ranks))}
    return events_by_rank, comms


def recompile_plan(stored: ExecutionPlan, *,
                   max_interleavings: int = MAX_INTERLEAVINGS,
                   cost_model=None) -> ExecutionPlan:
    """Re-derive and re-prove a stored plan from its own schedule: the
    full compile pipeline (dependence DAG, hoist points, equivalence
    prover) runs fresh on the reconstructed events.  The result's
    ``cache_key`` must equal the stored one — the signature check the
    elastic reinstall path enforces (a mismatch means the file does not
    contain the schedule it claims to)."""
    events_by_rank, comms = events_from_plan(stored)
    return compile_schedules(
        events_by_rank, comms, world_size=stored.world_size,
        detach_threshold=stored.detach_threshold,
        coalesce_bytes=stored.coalesce_bytes,
        bucket_bytes=stored.bucket_bytes,
        max_interleavings=max_interleavings, cost_model=cost_model)


#: bundle wire format: ``{"format": "plan-bundle", "version": 1,
#: "plans": {"<np>": <plan json>}}`` — one verified plan per world size
#: a shrinking elastic job may pass through.  ``launch --plan
#: --elastic`` emits these (one analyzer run per size), and
#: ``planrt``/``bridge.rebuild`` pick the surviving size's plan at
#: recovery.
BUNDLE_FORMAT = "plan-bundle"
BUNDLE_VERSION = 1


def save_bundle(plans, path: str) -> str:
    """Atomically write a plan bundle from ``{world_size: plan}`` (or
    an iterable of plans)."""
    if not isinstance(plans, dict):
        plans = {p.world_size: p for p in plans}
    payload = {
        "format": BUNDLE_FORMAT,
        "version": BUNDLE_VERSION,
        "analyzer_version": ANALYZER_VERSION,
        "plans": {str(int(n)): p.to_json()
                  for n, p in sorted(plans.items())},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def is_bundle(data) -> bool:
    return isinstance(data, dict) and data.get("format") == BUNDLE_FORMAT


def _bundle_from_data(data: dict, path: str) -> Dict[int, ExecutionPlan]:
    if int(data.get("version", -1)) != BUNDLE_VERSION:
        raise ValueError(
            f"plan bundle {path} has version {data.get('version')!r}, "
            f"expected {BUNDLE_VERSION}")
    out: Dict[int, ExecutionPlan] = {}
    for n, pdata in data.get("plans", {}).items():
        plan = ExecutionPlan.from_json(pdata)
        if plan.analyzer_version != ANALYZER_VERSION:
            raise ValueError(
                f"plan bundle {path} was compiled by analyzer "
                f"{plan.analyzer_version!r}, this is "
                f"{ANALYZER_VERSION!r} — recompile")
        out[int(n)] = plan
    return out


def load_bundle(path: str) -> Dict[int, ExecutionPlan]:
    """``{world_size: plan}`` from a bundle file; raises ``ValueError``
    on anything else (including version/analyzer drift — stale bundles
    must invalidate, not misexecute)."""
    with open(path) as f:
        data = json.load(f)
    if not is_bundle(data):
        raise ValueError(f"{path} is not a plan bundle")
    return _bundle_from_data(data, path)


def load_plan_for_size(path: str, world_size: int) -> Optional[ExecutionPlan]:
    """The plan serving ``world_size`` from ``path`` — a single-plan
    file (must match the size exactly) or a bundle (picks the size's
    entry).  None when the file holds no plan for that size; raises on
    unreadable/stale files.  One read + one parse — this sits on the
    elastic-recovery reinstall path."""
    with open(path) as f:
        data = json.load(f)
    if is_bundle(data):
        return _bundle_from_data(data, path).get(int(world_size))
    plan = _plan_from_data(data, path)
    return plan if plan.world_size == int(world_size) else None
