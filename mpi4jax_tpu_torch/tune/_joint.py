"""Joint tuning: one search over algorithm x quantization x topology.

The port's copy of ``mpi4jax_tpu/tune/_joint.py``: the same combination
grammar, eligibility rules, synthetic cost table, anchors, model-seeded
search and merge, so that both packages crown the same winners from the
same measurements.

A **combo** names one point of the joint space:

- a plain algorithm (``ring``/``rd``/``tree``): exact wire;
- a quantized wire format (``qring``/``qrd``), forcible per call;
- a hierarchical schedule (``hring``/``htree``), forcible per call on a
  multi-island comm;
- a gated variant (``hring+q``/``htree+q``): the hierarchical schedule
  with its leader leg quantized, which exists only under
  ``MPI4JAX_TPU_COLL_QUANT=force`` (the transport latches the gate per
  process, so the driver measures these in a sub-job of their own);
- an intra-island-leg variant (``hring+ici``/... and ``hring+q+ici``/...):
  the hierarchical schedule with its intra-island leg on the card
  (``topo/_ici_leg.py``: kernel 3 folds each island, kernel 4 packs the
  quantized frame), which needs ``MPI4JAX_TPU_ICI_LEG`` active (``force``
  in the driver's sub-jobs).  A shape where the leg cannot run excludes
  these combos: they would time the plain schedule under a wrong label.

:func:`joint_search` measures every eligible combo at a few anchor sizes,
fits the cost model, then at every other size measures only the model's
top-k predictions (and every combo it has no opinion on) and crowns the
best *measured* combo.  :func:`merge_winners` folds the sub-jobs' rows
into one winner table, which ``tune.cache_from_joint`` writes as the v2
cache's per-size-band combinations.  Stdlib only: the CLI
(``__main__.py``) supplies the live ``measure``, tests a synthetic one.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ._model import CostModel

#: gated-variant suffix: the combo's leader leg rides the quantized
#: wire under MPI4JAX_TPU_COLL_QUANT=force
QUANT_LEG_SUFFIX = "+q"

#: gated-variant suffix: the combo's intra-island leg rides the card
#: (kernels 3 and 4, topo/_ici_leg.py) under MPI4JAX_TPU_ICI_LEG=force
ICI_LEG_SUFFIX = "+ici"

#: every point of the joint space per op (allgather has no quantized
#: schedule — it is pure data movement and the wire format is lossy —
#: and no ICI-leg variant — the leg is an f32 SUM allreduce schedule)
JOINT_CANDIDATES: Dict[str, Tuple[str, ...]] = {
    "allreduce": ("ring", "rd", "tree", "qring", "qrd",
                  "hring", "htree", "hring+q", "htree+q",
                  "hring+ici", "htree+ici", "hring+q+ici", "htree+q+ici"),
    "allgather": ("ring", "rd", "tree", "hring", "htree"),
    # the expert-routing exchange: quantized/hierarchical twins are
    # first-class per-call-forcible codes (hqalltoall quantizes ONLY
    # the leader leg, so no "+q" gated sub-job is needed — the code
    # itself names the quantized-leader schedule), and there is no
    # ICI-leg variant (the leg is an allreduce schedule)
    "alltoall": ("ring", "qalltoall", "halltoall", "hqalltoall"),
}


def _combo_parts(combo: str) -> Tuple[str, frozenset]:
    """``"hring+q+ici"`` -> ``("hring", {"q", "ici"})``."""
    parts = str(combo).split("+")
    return parts[0], frozenset(parts[1:])


def combo_algo(combo: str) -> str:
    """The per-call-forcible algorithm under a combo label."""
    return _combo_parts(combo)[0]


def combo_gates(combo: str) -> Dict[str, str]:
    """Env gates (beyond the allow defaults) a combo needs to run as
    measured.  Empty for every per-call-forcible combo; the suffixes
    compose (``hring+q+ici`` needs both force gates)."""
    _, legs = _combo_parts(combo)
    gates: Dict[str, str] = {}
    if "q" in legs:
        gates["MPI4JAX_TPU_COLL_QUANT"] = "force"
    if "ici" in legs:
        gates["MPI4JAX_TPU_ICI_LEG"] = "force"
    return gates


def check_combo(combo: str, op: str) -> str:
    combo = str(combo).strip()
    if combo not in JOINT_CANDIDATES.get(op, ()):
        raise ValueError(
            f"unknown joint combination {combo!r} for {op} "
            f"(expected one of {JOINT_CANDIDATES.get(op)})")
    return combo


def eligible_combos(op: str, *, multi_island: bool, quant_mode: str,
                    hier_mode: str, ici_leg: bool = False) -> List[str]:
    """The combos worth measuring on THIS deployment shape: quantized
    wire formats drop under quant deny (the engine would degrade the
    rows right back), hierarchical schedules need a discovered
    multi-island topology (anywhere else they degrade to their flat
    twins and the sweep would time ring/tree twice under wrong
    labels), the quantized-leader-leg variants need both, and the
    ``+ici`` variants need the intra-island leg to actually activate
    here (``ici_leg`` — no island on cards under ``auto``, or
    ``MPI4JAX_TPU_ICI_LEG=off``, excludes them: a row timing the
    native intra path under an ``+ici`` label would be a lie)."""
    # the engine's vocabulary (A2A_*: the alltoall schedule family)
    from . import A2A_HIER, A2A_QUANT, HIER_ALGOS, QUANT_ALGOS

    out = []
    for combo in JOINT_CANDIDATES[op]:
        algo, legs = _combo_parts(combo)
        quantized = algo in QUANT_ALGOS or algo in A2A_QUANT \
            or "q" in legs
        if quantized and quant_mode == "deny":
            continue
        if (algo in HIER_ALGOS or algo in A2A_HIER) \
                and (not multi_island or hier_mode == "deny"):
            continue
        if "ici" in legs and not ici_leg:
            continue
        out.append(combo)
    return out


def synthetic_measure(ranks: int) -> Callable[[str, int, str],
                                              Optional[float]]:
    """A deterministic alpha-beta cost table shaped like a real
    multi-island deployment, for driving :func:`joint_search` without
    live communication (the verify-scale harness and tuner unit tests
    at virtual world sizes): hierarchical schedules amortize the
    inter-island latency term, quantized wire formats cut the
    bandwidth term, the ICI leg shaves intra-island latency.  Same
    (op, nbytes, combo) → same seconds, every call, every host — the
    point is search-machinery sanity at scale, not real timings."""
    def measure(op: str, nbytes: int, combo: str) -> Optional[float]:
        algo, legs = _combo_parts(combo)
        alpha = 40e-6 if algo.startswith("h") else 120e-6
        beta = 2.0e-9
        if algo in ("qring", "qrd", "qalltoall", "hqalltoall") \
                or "q" in legs:
            beta *= 0.55
        if "ici" in legs:
            alpha *= 0.8
        steps = 2.0 if op == "allreduce" else 1.0
        return alpha * steps + beta * float(nbytes) \
            + 1e-9 * max(0, ranks - 1)
    return measure


def _anchor_sizes(sizes: Sequence[int], n_anchors: int = 3) -> List[int]:
    """The sizes every combo is measured at to seed the model: the
    extremes plus the middle of the ladder (log-wise) — enough to pin
    each combo's alpha and beta, cheap enough to afford for every
    candidate."""
    ordered = sorted(set(int(s) for s in sizes))
    if len(ordered) <= n_anchors:
        return ordered
    picks = {ordered[0], ordered[-1], ordered[len(ordered) // 2]}
    return sorted(picks)


def joint_search(
    measure: Callable[[str, int, str], Optional[float]],
    candidates_by_op: Dict[str, Sequence[str]],
    sizes: Sequence[int],
    *,
    model: Optional[CostModel] = None,
    topk: int = 3,
    ranks: int = 0,
    log: Optional[Callable[[dict], None]] = None,
) -> Tuple[Dict[str, Dict[int, str]], List[dict], CostModel]:
    """Model-seeded joint search.

    ``measure(op, nbytes, combo)`` returns the agreed cross-rank median
    seconds of one live measurement, or None when the combo cannot be
    measured in this process (its gates are not active — the driver
    runs those in a sub-job).  ``model`` may arrive pre-seeded from
    ``--from-trace`` recordings; everything measured here is added to
    it, so the returned model reflects the live run.

    Returns ``(best, measurements, model)``: the best *measured* combo
    per (op, size), the measurement rows (cache-payload shaped, each
    stamped with its search phase), and the updated model.
    """
    model = model if model is not None else CostModel(world_size=ranks)
    best: Dict[str, Dict[int, str]] = {}
    measurements: List[dict] = []

    def _measure(op, nbytes, combo, phase):
        dt = measure(op, nbytes, combo)
        if dt is None:
            return None
        model.add_sample(op, combo, nbytes, dt)
        row = {"op": op, "bytes": int(nbytes), "combo": combo,
               "algo": combo_algo(combo), "seconds": round(float(dt), 9),
               "ranks": int(ranks), "phase": phase}
        gates = combo_gates(combo)
        if gates:
            # the cache payload's top-level knobs stamp records the
            # DRIVER's env; a gated combo's rows were measured under
            # their own sub-job gates — say so per row, or the stamp
            # would misstate exactly the measurements it exists for
            row["gates"] = gates
        measurements.append(row)
        if log is not None:
            log(row)
        return dt

    for op, cands in candidates_by_op.items():
        cands = [check_combo(c, op) for c in cands]
        if not cands:
            continue
        anchors = _anchor_sizes(sizes)
        measured: Dict[int, Dict[str, float]] = {}
        for nbytes in anchors:
            for combo in cands:
                dt = _measure(op, nbytes, combo, "anchor")
                if dt is not None:
                    measured.setdefault(nbytes, {})[combo] = dt
        for nbytes in sorted(set(int(s) for s in sizes)):
            here = measured.setdefault(nbytes, {})
            if nbytes not in anchors:
                ranked = model.rank_combos(op, nbytes, cands)
                # measure the model's top-k predictions plus every
                # combo it has no opinion on — prediction seeds, live
                # measurement decides
                chosen = [c for c, _ in ranked[:topk]]
                chosen += [c for c, p in ranked[topk:] if p is None]
                for combo in chosen:
                    dt = _measure(op, nbytes, combo, "refine")
                    if dt is not None:
                        here[combo] = dt
            if here:
                best.setdefault(op, {})[nbytes] = min(here, key=here.get)
    return best, measurements, model


def merge_winners(
    measurement_sets: Sequence[Sequence[dict]],
) -> Tuple[Dict[str, Dict[int, str]], List[dict]]:
    """Fold measurement rows from several sub-jobs (the base sweep and
    the gated ``+q``/``+ici`` sweeps) into one winner table: the best measured
    combo per (op, size) across every set, plus the concatenated rows.
    Re-measurements of one (op, size, combo) keep their best (the
    quietest observation of the same schedule)."""
    pooled: Dict[Tuple[str, int, str], float] = {}
    rows: List[dict] = []
    for mset in measurement_sets:
        for row in mset:
            combo = row.get("combo") or row.get("algo")
            if not combo or float(row.get("seconds", 0)) <= 0:
                continue
            key = (str(row["op"]), int(row["bytes"]), str(combo))
            dt = float(row["seconds"])
            if key not in pooled or dt < pooled[key]:
                pooled[key] = dt
            rows.append(row)
    best: Dict[str, Dict[int, str]] = {}
    per: Dict[Tuple[str, int], Dict[str, float]] = {}
    for (op, nbytes, combo), dt in pooled.items():
        per.setdefault((op, nbytes), {})[combo] = dt
    for (op, nbytes), by_combo in per.items():
        best.setdefault(op, {})[nbytes] = min(by_combo, key=by_combo.get)
    return best, rows
