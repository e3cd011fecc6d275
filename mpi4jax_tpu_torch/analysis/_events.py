"""Event and finding vocabulary for the static communication verifier.

A copy of ``mpi4jax_tpu/analysis/_events.py``; only the package names
differ.  Deliberately torch-free: the match simulation (``_match.py``) and
these data types run anywhere.  The event vocabulary, ``ANALYZER_VERSION``
and the report and plan formats are the JAX package's, so a schedule run
from a torch program hashes to the same ``cache_key`` and plan files cross
between the packages.

A :class:`CommEvent` is one communication operation as it appears in one
rank's ordered schedule — recorded by running a function once per rank
(``_schedule.py``) or a whole program in the virtual world (``_sim.py``).
Dtypes are numpy-style names (``"float32"``, not ``"torch.float32"``) and
shapes tuples of ints.  Field semantics follow the primitives' params
(``ops/_world_impl.SCHEDULE_SIGNATURES`` is the authoritative export).

Wildcard sentinels match ``utils/status.py`` (ANY_TAG = -1,
ANY_SOURCE = -2) but are re-declared here to keep this module
import-light.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

ANY_TAG = -1
ANY_SOURCE = -2

#: Version of the analyzer's extraction + matching + planning semantics.
#: Bumped whenever schedules, finding kinds, or the plan format change
#: meaning — cached plans and CI golden files key on it, so a semantic
#: change invalidates them instead of silently drifting.
ANALYZER_VERSION = "7.0"

#: Event kinds that move data point-to-point.
P2P_KINDS = frozenset({"send", "recv", "sendrecv", "shift2"})

#: Event kinds that are collective over every member of the comm.
COLLECTIVE_KINDS = frozenset({
    "allreduce", "reduce", "scan", "bcast", "allgather", "gather",
    "scatter", "alltoall", "barrier", "split",
})

#: Collective kinds whose semantics depend on a reduce operator.
REDUCING_KINDS = frozenset({"allreduce", "reduce", "scan"})

#: Collective kinds with a root parameter.
ROOTED_KINDS = frozenset({"reduce", "bcast", "gather", "scatter"})

_DTYPE_BYTES = {
    "bool": 1, "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
    "int8": 1, "int16": 2, "int32": 4, "int64": 8,
    "uint8": 1, "uint16": 2, "uint32": 4, "uint64": 8,
    "complex64": 8, "complex128": 16,
}


def event_nbytes(dtype, shape) -> Optional[int]:
    """Payload bytes from a (dtype string, shape tuple) pair, or None
    when either is unknown.  Kept numpy-free so the matcher and planner
    stay importable anywhere (the tier-1 standalone-loading contract)."""
    if dtype is None or shape is None:
        return None
    itemsize = _DTYPE_BYTES.get(str(dtype))
    if itemsize is None:  # "float32" styles covered above; parse "f4"/"<f8"
        digits = "".join(ch for ch in str(dtype) if ch.isdigit())
        if not digits:
            return None
        bits = int(digits)
        itemsize = bits // 8 if bits >= 8 else 1
    n = itemsize
    for d in shape:
        n *= int(d)
    return n


@dataclass
class CommEvent:
    """One communication op in one rank's schedule."""

    rank: int
    idx: int                       # position in this rank's schedule
    kind: str                      # see P2P_KINDS / COLLECTIVE_KINDS
    comm: Tuple = (0,)             # comm key (lineage tuple; same across ranks)
    # point-to-point routing (None where not applicable)
    dest: Optional[int] = None
    source: Optional[int] = None
    lo: Optional[int] = None       # shift2 neighbors (-1 = wall)
    hi: Optional[int] = None
    root: Optional[int] = None
    tag: Optional[int] = None      # send tag / directed recv tag
    sendtag: Optional[int] = None  # sendrecv split tags
    recvtag: Optional[int] = None
    reduce_op: Optional[str] = None
    dtype: Optional[str] = None
    shape: Optional[Tuple[int, ...]] = None
    site: str = ""                 # "file.py:123 (eqn 4 mpi4jax_tpu_send)"
    status: bool = False           # recv/sendrecv fills an MPI-style Status
    # internal matcher state (not part of identity)
    _sent: bool = field(default=False, repr=False, compare=False)

    @property
    def nbytes(self) -> Optional[int]:
        """Payload bytes of this event, or None when unknown."""
        return event_nbytes(self.dtype, self.shape)

    def describe(self) -> str:
        bits = [self.kind]
        if self.kind == "send":
            bits.append(f"to {self.dest} tag {self.tag}")
        elif self.kind == "recv":
            src = "ANY_SOURCE" if self.source == ANY_SOURCE else self.source
            tag = "ANY_TAG" if self.tag == ANY_TAG else self.tag
            bits.append(f"from {src} tag {tag}")
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
        where = f" @ {self.site}" if self.site else ""
        return " ".join(bits) + where

    def collective_signature(self):
        """The fields every rank must agree on for a matched collective.

        ``split`` deliberately excludes color/key (divergent colors are the
        point); reducing kinds include the operator; rooted kinds the root.
        """
        sig = [self.kind]
        if self.kind in REDUCING_KINDS:
            sig.append(("op", self.reduce_op))
        if self.kind in ROOTED_KINDS:
            sig.append(("root", self.root))
        if self.kind not in ("barrier", "split"):
            sig.append(("dtype", self.dtype))
            sig.append(("shape", self.shape))
        return tuple(sig)


def canonical_event(ev: "CommEvent") -> tuple:
    """The semantic identity of one event: every field that affects
    matching or planning, none of the presentation (site strings).  The
    schedule cache key and the golden-plan corpus hash these, so a
    comment shifting line numbers does not invalidate a cached plan."""
    return (ev.kind, tuple(ev.comm), ev.dest, ev.source, ev.lo, ev.hi,
            ev.root, ev.tag, ev.sendtag, ev.recvtag, ev.reduce_op,
            ev.dtype, None if ev.shape is None else tuple(ev.shape),
            bool(ev.status))


def schedule_cache_key(events_by_rank: dict, world_size: int) -> str:
    """sha256 over the canonical schedules + world size + analyzer
    version — the plan/schedule cache key ``analyze --json`` reports."""
    import hashlib

    h = hashlib.sha256()
    h.update(f"analyzer={ANALYZER_VERSION};np={world_size}".encode())
    for rank in sorted(events_by_rank):
        h.update(f";rank={rank}".encode())
        for ev in events_by_rank[rank]:
            h.update(repr(canonical_event(ev)).encode())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------------------
# findings

#: kind -> (severity, one-line description) — the finding catalogue
#: (docs/analysis.md carries a worked example per kind).
FINDING_KINDS = {
    "deadlock": ("error", "cyclic send/recv or collective wait"),
    "unmatched_send": ("error", "a sent message is never received"),
    "unmatched_recv": ("error", "a receive no rank ever sends to"),
    "tag_mismatch": ("error", "matched endpoints disagree on the tag"),
    "dtype_mismatch": ("error", "matched endpoints disagree on the dtype"),
    "shape_mismatch": ("error",
                       "matched endpoints disagree on the shape/byte count"),
    "collective_mismatch": ("error",
                            "ranks run different collectives at the same "
                            "program position"),
    "reduce_op_mismatch": ("error",
                           "ranks run the same collective with different "
                           "reduce operators"),
    "root_mismatch": ("error",
                      "ranks run the same collective with different roots"),
    "wildcard_starvation": ("error",
                            "an ANY_SOURCE receive has no send left to "
                            "match"),
    "token_violation": ("warning",
                        "a world op's effect token is unthreaded or "
                        "reordered (undefined order in explicit-token "
                        "mode)"),
    "order_critical_exchange": ("warning",
                                "cyclic send<->recv traffic between two "
                                "ranks: correct only under strict "
                                "program-order execution; any reordering "
                                "or missing effect edge deadlocks"),
    "control_divergence": ("warning",
                           "communication differs between cond branches; "
                           "data-dependent schedules cannot be verified "
                           "statically"),
    "comm_in_while": ("warning",
                      "communication inside a while loop: trip count is "
                      "data-dependent, one iteration assumed"),
    "rank_error": ("error", "a rank's program raised during analysis"),
    "analysis_timeout": ("error",
                         "the match simulation did not finish in time"),
}


@dataclass
class Finding:
    kind: str
    message: str
    ranks: Tuple[int, ...] = ()
    comm: Tuple = ()
    sites: Tuple[str, ...] = ()

    @property
    def severity(self) -> str:
        return FINDING_KINDS.get(self.kind, ("error", ""))[0]

    def format(self) -> str:
        ranks = ",".join(map(str, self.ranks)) if self.ranks else "-"
        head = f"{self.severity.upper():7s} {self.kind:24s} ranks {ranks:7s}"
        lines = [f"{head} {self.message}"]
        for s in self.sites:
            lines.append(f"{'':8s}  at {s}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "severity": self.severity,
            "message": self.message,
            "ranks": list(self.ranks),
            "comm": list(self.comm),
            "sites": list(self.sites),
        }


def collapse_findings(findings, class_of) -> list:
    """Symmetry-collapsed view of a finding list: findings whose rank
    tuples land in the same equivalence classes (same kind, same comm)
    merge into one entry — the lowest-rank representative finding plus
    the instance count and the affected-rank total.  Big-np reports
    stay readable and byte-stable: 510 identical ring findings become
    one representative + ``count: 510``.

    ``class_of`` maps rank -> class index (``SymmetryPartition.
    class_of``); ranks outside it (defensive) collapse as themselves.
    """
    groups: dict = {}
    order = []
    n = len(class_of)
    for f in findings:
        key = (f.kind,
               tuple(class_of[r] if 0 <= r < n else ("r", r)
                     for r in f.ranks),
               tuple(f.comm))
        g = groups.get(key)
        if g is None:
            g = groups[key] = {"rep": f, "count": 0, "ranks": set()}
            order.append(key)
        g["count"] += 1
        g["ranks"].update(f.ranks)
    return [
        {
            "kind": key[0],
            "representative": groups[key]["rep"].to_json(),
            "count": groups[key]["count"],
            "affected_ranks": len(groups[key]["ranks"]),
        }
        for key in order
    ]


@dataclass
class Report:
    """Verdict of one verification run."""

    world_size: int
    target: str                    # program path or function name
    findings: list
    schedules: dict = field(default_factory=dict)  # rank -> [event str]
    output: str = ""               # captured program stdout/stderr (sim)
    #: raw CommEvent lists (rank -> [CommEvent]) — the schedule compiler's
    #: input; not serialized (the string form above is the JSON view)
    events: dict = field(default_factory=dict, repr=False)
    #: comm key -> ordered world-rank member tuple, as matched
    comms: dict = field(default_factory=dict, repr=False)
    #: schedule/plan cache key: a hash of the canonical per-rank schedules
    #: + world size + ANALYZER_VERSION.  Plan caches and CI diffs key on
    #: it — same program, same analyzer ⇒ same key.
    cache_key: str = ""
    analyzer_version: str = ANALYZER_VERSION
    #: attached by the schedule compiler (analysis._plan) when --optimize
    #: runs: a PlanResult, or None
    plan: object = field(default=None, repr=False)
    #: rank-symmetry partition (analysis._symbolic.SymmetryPartition)
    #: when the world canonicalized, else None — drives the symmetry-
    #: collapsed findings view in to_json and the quotient prover
    symmetry: object = field(default=None, repr=False)

    @property
    def ok(self) -> bool:
        return not self.findings

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == "warning"]

    def kinds(self):
        return {f.kind for f in self.findings}

    def format_table(self, *, show_schedules: bool = False) -> str:
        lines = [
            f"static verify: {self.target} at world size {self.world_size}"
        ]
        if not self.findings:
            lines.append("CLEAN   no findings")
        for f in self.findings:
            lines.append(f.format())
        if show_schedules:
            for rank in sorted(self.schedules):
                lines.append(f"-- rank {rank} schedule --")
                for s in self.schedules[rank]:
                    lines.append(f"   {s}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        out = {
            "target": self.target,
            "world_size": self.world_size,
            "ok": self.ok,
            "analyzer_version": self.analyzer_version,
            "cache_key": self.cache_key,
            "findings": [f.to_json() for f in self.findings],
            "schedules": {
                str(r): list(v) for r, v in self.schedules.items()
            },
        }
        if self.plan is not None:
            out["plan"] = self.plan.to_json()
        if self.symmetry is not None:
            sym = self.symmetry.to_json()
            sym["findings_collapsed"] = collapse_findings(
                self.findings, self.symmetry.class_of)
            out["symmetry"] = sym
        return out
