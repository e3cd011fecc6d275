"""Collective cost model: fit from recorded timings, predict anywhere.

The port's copy of ``mpi4jax_tpu/tune/_model.py``, line for line below
this docstring, so that a model file written by either package loads in
the other and both fit the same coefficients from the same samples.

The joint tuner (``_joint.py``, ``python -m mpi4jax_tpu_torch.tune
--joint``) needs one answer to "how long will this collective take?" per
(op, algorithm combination, payload size) on the topology the
measurements came from.  A :class:`CostModel` holds the measured medians
and fits an **alpha-beta** curve per (op, combo),

    t(b) = alpha + b * beta        (startup latency + inverse bandwidth)

by weighted least squares (weights ``1/t^2``: relative error, so the
microsecond end of the sweep is not drowned by the 16 MiB end).  A query
at a measured size returns the measurement; between measured sizes it
log-log interpolates; outside the measured range it rides the fitted
line, clamped below the smallest measurement.  The fit only extrapolates,
never overrides data.

Samples come from recordings of real runs (``tune.fit_model_from_events``,
with the wire and dispatch fractions per sample) and from the tuner's
measurement rows (``from_measurements``).  Stdlib only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

MODEL_VERSION = 1

#: default candidate ladder for gradient-bucket sizing (bytes)
BUCKET_LADDER = tuple(1 << p for p in range(16, 23))  # 64 KiB .. 4 MiB

#: concurrency-group cap bounds the model may suggest (the compiler's
#: static default, _deps.MAX_GROUP = 4, sits inside this range)
MIN_GROUP_CAP = 2
MAX_GROUP_CAP = 8


def _median(values: Sequence[float]) -> float:
    """Interpolated median, identical to numpy's / the profile report's
    p50 on the same samples (the tune package's house convention)."""
    vals = sorted(float(v) for v in values)
    n = len(vals)
    return (vals[(n - 1) // 2] + vals[n // 2]) / 2.0


def _fit_alpha_beta(points: Dict[int, float]) -> Tuple[float, float]:
    """Weighted least squares of ``t = alpha + beta * bytes`` over
    ``{bytes: seconds}`` with weights ``1/t^2`` (relative error).
    Degenerate inputs fall back conservatively: one point becomes a
    pure-bandwidth line through it, so extrapolation never predicts a
    free collective."""
    items = [(float(b), float(t)) for b, t in points.items() if t > 0]
    if not items:
        return 0.0, 0.0
    if len(items) == 1:
        b, t = items[0]
        return (t, 0.0) if b <= 0 else (0.0, t / b)
    sw = swx = swy = swxx = swxy = 0.0
    for b, t in items:
        w = 1.0 / (t * t)
        sw += w
        swx += w * b
        swy += w * t
        swxx += w * b * b
        swxy += w * b * t
    denom = sw * swxx - swx * swx
    if denom <= 0:
        b, t = items[-1]
        return (0.0, t / b) if b > 0 else (t, 0.0)
    beta = (sw * swxy - swx * swy) / denom
    alpha = (swy - beta * swx) / sw
    # a fitted negative coefficient (noise on a near-flat curve) would
    # predict negative times out of range; clamp to the physical floor
    return max(alpha, 0.0), max(beta, 0.0)


class CostModel:
    """Measured medians + fitted alpha-beta curves per (op, combo).

    A *combo* is the joint tuner's algorithm-combination label: a plain
    algorithm name (``ring``/``qring``/``hring``/...) or a gated
    variant (``hring+q`` — the hierarchical ring with its leader leg
    quantized under ``MPI4JAX_TPU_COLL_QUANT=force``).  The model does
    not interpret combos; ``_joint.py`` owns their semantics.
    """

    def __init__(self, *, world_size: int = 0, topology: Optional[str] = None,
                 dtype: str = "float32", knobs: Optional[dict] = None,
                 source: str = ""):
        self.world_size = int(world_size)
        self.topology = topology
        self.dtype = str(dtype)
        self.knobs = dict(knobs or {})
        self.source = str(source)
        #: (op, combo) -> {nbytes: median seconds}
        self.samples: Dict[Tuple[str, str], Dict[int, float]] = {}
        #: (op, combo) -> {nbytes: mean wire fraction} (may be sparse)
        self.wire_frac: Dict[Tuple[str, str], Dict[int, float]] = {}
        #: (op, combo) -> {nbytes: mean dispatch fraction} (may be sparse)
        self.dispatch_frac: Dict[Tuple[str, str], Dict[int, float]] = {}
        self._fits: Dict[Tuple[str, str], Tuple[float, float]] = {}

    # -- construction ---------------------------------------------------

    def add_sample(self, op: str, combo: str, nbytes: int, seconds: float,
                   *, wire_frac: Optional[float] = None,
                   dispatch_frac: Optional[float] = None) -> None:
        key = (str(op), str(combo))
        self.samples.setdefault(key, {})[int(nbytes)] = float(seconds)
        if wire_frac is not None:
            self.wire_frac.setdefault(key, {})[int(nbytes)] = \
                float(wire_frac)
        if dispatch_frac is not None:
            self.dispatch_frac.setdefault(key, {})[int(nbytes)] = \
                float(dispatch_frac)
        self._fits.pop(key, None)

    @classmethod
    def from_measurements(cls, measurements, **meta) -> "CostModel":
        """Build from tuner/benchmark measurement rows (dicts with
        ``op``/``bytes``/``seconds`` and a combination label under
        ``combo`` or ``algo``).  Multiple rows for one (op, combo,
        bytes) collapse to their median."""
        acc: Dict[Tuple[str, str, int], List[float]] = {}
        fracs: Dict[Tuple[str, str, int], Dict[str, float]] = {}
        for row in measurements:
            combo = row.get("combo") or row.get("algo")
            if not combo or row.get("op") is None:
                continue
            secs = float(row.get("seconds", 0.0))
            if secs <= 0:
                continue
            key = (str(row["op"]), str(combo), int(row["bytes"]))
            acc.setdefault(key, []).append(secs)
            for frac in ("wire_frac", "dispatch_frac"):
                if row.get(frac) is not None:
                    fracs.setdefault(key, {})[frac] = float(row[frac])
        model = cls(**meta)
        for (op, combo, nbytes), vals in sorted(acc.items()):
            fr = fracs.get((op, combo, nbytes), {})
            model.add_sample(op, combo, nbytes, _median(vals),
                             wire_frac=fr.get("wire_frac"),
                             dispatch_frac=fr.get("dispatch_frac"))
        return model

    # -- prediction -----------------------------------------------------

    def combos(self, op: str) -> List[str]:
        """Combination labels the model has samples for, for one op."""
        return sorted(c for (o, c) in self.samples if o == op)

    def _fit(self, key: Tuple[str, str]) -> Tuple[float, float]:
        if key not in self._fits:
            self._fits[key] = _fit_alpha_beta(self.samples.get(key, {}))
        return self._fits[key]

    def predict(self, op: str, nbytes: int,
                combo: str) -> Optional[float]:
        """Predicted seconds for one collective, or None when the model
        has never seen (op, combo) — the joint tuner treats None as
        "must measure live"."""
        key = (str(op), str(combo))
        pts = self.samples.get(key)
        if not pts:
            return None
        nbytes = int(nbytes)
        if nbytes in pts:
            return pts[nbytes]
        sizes = sorted(pts)
        lo = max((s for s in sizes if s < nbytes), default=None)
        hi = min((s for s in sizes if s > nbytes), default=None)
        if lo is not None and hi is not None:
            # log-log interpolation between the bracketing measurements
            import math

            f = ((math.log(nbytes) - math.log(lo))
                 / (math.log(hi) - math.log(lo)))
            return math.exp(math.log(pts[lo]) * (1 - f)
                            + math.log(pts[hi]) * f)
        alpha, beta = self._fit(key)
        pred = alpha + beta * nbytes
        if hi is not None:
            # below the measured range, clamp to what the data implies:
            # at most the smallest measurement (smaller payload, same
            # schedule), and at least its pure-bandwidth scaling —
            # per-byte cost alpha/b + beta is non-increasing in b, so
            # t(b) >= (b/B) * t(B) for b < B holds for ANY alpha-beta
            # curve.  Without the floor, an alpha fit near zero (two
            # wire-bound large samples) would fabricate a near-free
            # 1 KB op and bias bucket pricing / combo seeding.
            floor = pts[hi] * nbytes / hi
            return min(max(pred, floor), pts[hi])
        return max(pred, 0.0)

    def rank_combos(self, op: str, nbytes: int,
                    candidates: Sequence[str]):
        """``[(combo, predicted seconds | None), ...]`` sorted fastest
        first; unpredictable combos (no samples) sort last, so a search
        that measures the top-k always includes the genuinely unknown
        ones in its "must measure" tail."""
        scored = [(c, self.predict(op, nbytes, c)) for c in candidates]
        return sorted(scored,
                      key=lambda cp: (cp[1] is None,
                                      cp[1] if cp[1] is not None else 0.0))

    # -- what the schedule compiler asks --------------------------------

    def best_bucket_bytes(self, total_bytes: int,
                          ladder: Sequence[int] = BUCKET_LADDER,
                          op: str = "allreduce",
                          combo: Optional[str] = None) -> Optional[int]:
        """The gradient-bucket ceiling minimizing the predicted cost of
        syncing ``total_bytes`` of small gradients: ``ceil(total/b)``
        buckets each paying ``predict(op, b)``.  ``combo`` defaults to
        the model's best-predicted combination at each candidate size
        (the decision table will be tuned from the same model, so the
        bucketed allreduces really run that pick).  None when the model
        has no samples for the op (the compiler then keeps its static
        default)."""
        total = max(int(total_bytes), 1)
        cands = self.combos(op)
        if not cands:
            return None

        def _pred(nbytes):
            if combo is None:
                preds = [p for _, p in self.rank_combos(op, nbytes, cands)
                         if p is not None]
                return preds[0] if preds else None
            return self.predict(op, nbytes, combo)

        best_b, best_cost = None, None
        # descending, with a 0.1% improvement bar: near-ties keep the
        # LARGER bucket (fewer dispatches, same predicted wire time)
        for b in sorted((int(b) for b in ladder), reverse=True):
            # full buckets at b, plus one remainder bucket at its own
            # (smaller) predicted cost — pricing the tail at the full
            # bucket size would overcharge every ceiling > total
            full, rem = divmod(total, b)
            cost = 0.0
            if full:
                per = _pred(b)
                if per is None:
                    continue
                cost += full * per
            if rem:
                per = _pred(rem)
                if per is None:
                    continue
                cost += per
            if best_cost is None or cost < best_cost * 0.999:
                best_b, best_cost = b, cost
        return best_b

    def suggested_group_cap(self, nbytes: int, op: str = "send",
                            combo: str = "ring",
                            default: int = 4) -> int:
        """Concurrency-group cap for the schedule compiler: how many
        independent ops' completions are worth keeping outstanding
        together.  Dispatch-dominated sizes (the fitted startup alpha
        is most of the predicted time) benefit from deeper groups —
        each deferred completion hides another alpha — while wire-bound
        sizes gain nothing past the default.  Clamped to
        [MIN_GROUP_CAP, MAX_GROUP_CAP]; ``default`` when the model has
        no samples for (op, combo)."""
        key = (str(op), str(combo))
        if not self.samples.get(key):
            # sends are not recorded per-algorithm; fall back to any
            # same-op samples before giving up
            alts = [c for (o, c) in self.samples if o == op]
            if not alts:
                return int(default)
            key = (str(op), alts[0])
        alpha, beta = self._fit(key)
        t = alpha + beta * max(int(nbytes), 1)
        if t <= 0:
            return int(default)
        alpha_share = alpha / t
        if alpha_share >= 0.5:
            cap = MAX_GROUP_CAP
        elif alpha_share >= 0.25:
            cap = 6
        else:
            cap = int(default)
        return max(MIN_GROUP_CAP, min(MAX_GROUP_CAP, cap))

    # -- persistence ----------------------------------------------------

    def to_json(self) -> dict:
        def _grid(table):
            return {f"{op}/{combo}": {str(b): v
                                      for b, v in sorted(pts.items())}
                    for (op, combo), pts in sorted(table.items())}

        return {
            "version": MODEL_VERSION,
            "world_size": self.world_size,
            "topology": self.topology,
            "dtype": self.dtype,
            "knobs": dict(self.knobs),
            "source": self.source,
            "samples": _grid(self.samples),
            "wire_frac": _grid(self.wire_frac),
            "dispatch_frac": _grid(self.dispatch_frac),
        }

    @classmethod
    def from_json(cls, data: dict) -> "CostModel":
        if int(data.get("version", -1)) != MODEL_VERSION:
            raise ValueError(
                f"cost model has version {data.get('version')!r}, "
                f"expected {MODEL_VERSION}")
        model = cls(world_size=int(data.get("world_size", 0)),
                    topology=data.get("topology"),
                    dtype=data.get("dtype", "float32"),
                    knobs=data.get("knobs"),
                    source=data.get("source", ""))

        def _load(table, dest):
            for key, pts in (table or {}).items():
                op, _, combo = key.partition("/")
                dest[(op, combo)] = {int(b): float(v)
                                     for b, v in pts.items()}

        _load(data.get("samples"), model.samples)
        _load(data.get("wire_frac"), model.wire_frac)
        _load(data.get("dispatch_frac"), model.dispatch_frac)
        return model


def model_path(world_size: int,
               topo_fingerprint: Optional[str] = None) -> str:
    """Default persistent path: ``MPI4JAX_TPU_TUNE_MODEL`` overrides,
    else ``~/.cache/mpi4jax_tpu/model_<size>[_<topohash>].json`` beside
    the tune cache."""
    forced = os.environ.get("MPI4JAX_TPU_TUNE_MODEL")
    if forced and forced.strip():
        return forced
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    suffix = f"_{topo_fingerprint}" if topo_fingerprint else ""
    return os.path.join(base, "mpi4jax_tpu",
                        f"model_{int(world_size)}{suffix}.json")


def save_model(model: CostModel, path: Optional[str] = None) -> str:
    p = path or model_path(model.world_size, model.topology)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    tmp = f"{p}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(model.to_json(), f, indent=1, sort_keys=True)
    os.replace(tmp, p)
    return p


def load_model(path: str) -> CostModel:
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "samples" not in data:
        raise ValueError(f"{path} is not a cost-model file")
    return CostModel.from_json(data)
