"""The environment knobs that the port's world tier reads.

A copy of the parsers of ``mpi4jax_tpu/utils/config.py`` for the knobs of
the hierarchical allreduce and its intra-island leg, with the JAX
package's names, accepted values and errors: a malformed value raises
``ValueError`` (the native transport exits on the same values), so no
typo silently changes routing or numerics.

- ``MPI4JAX_TPU_COLL_QUANT``: allow | deny | force (the quantized wire);
- ``MPI4JAX_TPU_TOPO``: auto | off (topology discovery at comm creation);
- ``MPI4JAX_TPU_HIER``: allow | deny | force (the hierarchical schedules);
- ``MPI4JAX_TPU_ICI_LEG``: auto | off | force (the intra-island leg on the
  card, ``topo/_ici_leg.py``);
- ``MPI4JAX_TPU_FAKE_HOSTS``: the virtual host partition of one machine;
- ``MPI4JAX_TPU_PLAN_BUCKET_KB``: the gradient bucket of
  ``parallel/dp.py``, in KiB;
- ``MPI4JAX_TPU_DEBUG``: per-call debug lines (``utils/tracing.py``), a
  boolean flag;
- ``MPI4JAX_TPU_TRACE``: arm the observability recorder (``obs/``) and
  dump this rank's recording to ``<value>.rank<r>.json`` at exit (the
  launcher's ``--trace`` sets it);
- ``MPI4JAX_TPU_TRACE_BUF_KB``: the event rings' size in KB (default 256,
  read by ``obs._recorder.default_capacity_events``);
- ``MPI4JAX_TPU_TUNE_CACHE``: the full path of the persistent tune cache
  (``tune.cache_path``);
- ``MPI4JAX_TPU_COLL_ALGO``: the operator's algorithm override, the
  strongest layer of ``tune``'s table (parsed by ``tune._env_table``);
- ``MPI4JAX_TPU_HOST``: this rank's reachable address for
  ``WorldComm.from_mpi`` (default 127.0.0.1);
- ``MPI4JAX_TPU_CKPT_DIR``: the default directory of the sharded
  checkpoints (``utils/checkpoint.py``);
- ``MPI4JAX_TPU_TUNE_MODEL``: the full path of the joint tuner's cost-model
  file (``tune._model.model_path``);
- ``MPI4JAX_TPU_ANALYZE_TIMEOUT_S``: the static verifier's wall deadline
  for one virtual-world run (``analysis/_sim.py``), seconds, default 120,
  0 for none;
- ``MPI4JAX_TPU_ANALYZE_SYMBOLIC``: auto | off, the verifier's
  rank-symbolic path (``analysis/_symbolic.py`` reads it itself, with this
  parser's rules);
- ``MPI4JAX_TPU_PLAN``: a verified plan file or bundle for plan execution
  (``runtime/planrt.py``, which resolves it once per process; the
  launcher's ``--plan`` sets it), a bare enable, or off;
- ``MPI4JAX_TPU_LIVE``: off | auto, live re-tuning (``live/``; the
  launcher's ``--live`` sets auto), with ``MPI4JAX_TPU_LIVE_WINDOW`` (the
  controller's window in events, default 256), ``_LIVE_DRIFT_PCT`` (the
  drift threshold in percent, default 30) and ``_LIVE_COOLDOWN_OPS``
  (world-collective boundaries between swaps, default 64; the epoch
  rendezvous runs every quarter of it);
- ``MPI4JAX_TPU_ELASTIC``: a boolean, elastic worlds (``elastic/``): a
  transport failure raises ``elastic.RankFailure`` after poisoning the
  peers, instead of exiting the process (the launcher's ``--elastic`` sets
  it), with ``MPI4JAX_TPU_ELASTIC_DIR`` (the coordination directory where
  the launcher announces each generation as ``gen_<n>.json``),
  ``_ELASTIC_POLICY`` (shrink | respawn, default shrink) and
  ``_ELASTIC_GRACE_S`` (how long ``elastic.recover`` waits for the next
  announcement, seconds, default 60);
- ``MPI4JAX_TPU_GENERATION``: the world generation a process was born into
  (default 0; the elastic launcher exports it to respawned ranks, and
  ``elastic.recover`` advances it);
- ``MPI4JAX_TPU_SLOT``: a respawned rank's launcher slot, when it differs
  from its bootstrap rank (read by ``elastic.my_slot``; the generation maps
  key on slots, which never renumber).

``knob_env`` stamps the resolved gates into tune caches and benchmark
records, as the JAX package does (the live knobs are not among them there
either).
"""

from __future__ import annotations

import os
from typing import Optional


def _choice(name: str, default: str, values: tuple) -> str:
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip()
    if not v:
        return default
    if v in values:
        return v
    expected = ", ".join(values[:-1]) + f", or {values[-1]}" \
        if len(values) > 2 else " or ".join(values)
    raise ValueError(f"cannot parse {name}={raw!r} (expected {expected})")


def quant_mode() -> str:
    """``MPI4JAX_TPU_COLL_QUANT`` as "allow" | "deny" | "force"."""
    return _choice("MPI4JAX_TPU_COLL_QUANT", "allow",
                   ("allow", "deny", "force"))


def topo_mode() -> str:
    """``MPI4JAX_TPU_TOPO`` as "auto" | "off"."""
    return _choice("MPI4JAX_TPU_TOPO", "auto", ("auto", "off"))


def hier_mode() -> str:
    """``MPI4JAX_TPU_HIER`` as "allow" | "deny" | "force"."""
    return _choice("MPI4JAX_TPU_HIER", "allow", ("allow", "deny", "force"))


def ici_leg_mode() -> str:
    """``MPI4JAX_TPU_ICI_LEG`` as "auto" | "off" | "force"."""
    return _choice("MPI4JAX_TPU_ICI_LEG", "auto", ("auto", "off", "force"))


def fake_hosts_spec() -> Optional[str]:
    """The raw ``MPI4JAX_TPU_FAKE_HOSTS`` spec, or None."""
    raw = os.environ.get("MPI4JAX_TPU_FAKE_HOSTS")
    return raw if raw and raw.strip() else None


def plan_bucket_bytes() -> int:
    """``MPI4JAX_TPU_PLAN_BUCKET_KB`` in bytes (default 1 MiB; 0 disables
    gradient bucketing; a negative value counts as 0), the value that
    ``analysis._plan.default_bucket_bytes`` reads for a set knob."""
    raw = os.environ.get("MPI4JAX_TPU_PLAN_BUCKET_KB")
    if raw is None or not raw.strip():
        return 1 << 20
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"cannot parse MPI4JAX_TPU_PLAN_BUCKET_KB={raw!r} as KB")
    return max(0, v) * 1024


def _positive_int_knob(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"cannot parse {name}={raw!r} as an integer")
    if v <= 0:
        raise ValueError(f"{name}={raw!r} must be a positive integer")
    return v


def live_mode() -> str:
    """``MPI4JAX_TPU_LIVE`` as "off" | "auto".  Strict: ranks that
    disagree on the mode would rendezvous on different collective
    sequences, so a typo raises.  "off" arms nothing: no thread, no
    boundary hook, no event ring."""
    raw = os.environ.get("MPI4JAX_TPU_LIVE")
    if raw is None or not raw.strip():
        return "off"
    v = raw.strip()
    if v in ("off", "auto"):
        return v
    raise ValueError(
        f"cannot parse MPI4JAX_TPU_LIVE={raw!r} (expected off or auto)")


def live_window() -> int:
    """``MPI4JAX_TPU_LIVE_WINDOW``: the controller's rolling window over
    the native event ring, in events (positive, default 256)."""
    return _positive_int_knob("MPI4JAX_TPU_LIVE_WINDOW", 256)


def live_drift_pct() -> float:
    """``MPI4JAX_TPU_LIVE_DRIFT_PCT``: how far, in percent, an observed
    (op, size band, algorithm) median may leave the cost model's
    prediction before it counts as drift (positive, default 30)."""
    raw = os.environ.get("MPI4JAX_TPU_LIVE_DRIFT_PCT")
    if raw is None or not raw.strip():
        return 30.0
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(
            f"cannot parse MPI4JAX_TPU_LIVE_DRIFT_PCT={raw!r} as percent")
    if v <= 0:
        raise ValueError(
            f"MPI4JAX_TPU_LIVE_DRIFT_PCT={raw!r} must be > 0")
    return v


def live_cooldown_ops() -> int:
    """``MPI4JAX_TPU_LIVE_COOLDOWN_OPS``: world-collective boundaries
    between table swaps (positive, default 64); the epoch rendezvous runs
    every ``cooldown // 4`` boundaries (at least every one)."""
    return _positive_int_knob("MPI4JAX_TPU_LIVE_COOLDOWN_OPS", 64)


def _float_knob(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"cannot parse {name}={raw!r} as seconds")
    # an explicit non-positive value means OFF, not "use the default"
    return v if v > 0 else 0.0


def analyze_timeout_s() -> float:
    """``MPI4JAX_TPU_ANALYZE_TIMEOUT_S`` in seconds (default 120; 0 = no
    deadline, as ``MPI4JAX_TPU_TIMEOUT_S``)."""
    return _float_knob("MPI4JAX_TPU_ANALYZE_TIMEOUT_S", 120.0)


def analyze_symbolic_mode() -> str:
    """``MPI4JAX_TPU_ANALYZE_SYMBOLIC`` as "auto" | "off", strict: a typo
    raises rather than changing which path gave a verdict.  The same
    parse as ``analysis._symbolic.symbolic_mode``, which reads the
    environment itself to stay loadable alone."""
    raw = os.environ.get("MPI4JAX_TPU_ANALYZE_SYMBOLIC")
    if raw is None or not raw.strip():
        return "auto"
    v = raw.strip()
    if v in ("auto", "off"):
        return v
    raise ValueError(
        f"cannot parse MPI4JAX_TPU_ANALYZE_SYMBOLIC={raw!r} "
        "(expected auto or off)")


_TRUTHY = frozenset(("1", "true", "on", "yes", "y"))
_FALSY = frozenset(("0", "false", "off", "no", "n", ""))


def parse_bool(value: str, *, name: str = "<flag>") -> bool:
    v = value.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    raise ValueError(f"cannot parse boolean env var {name}={value!r}")


def flag(name: str, default: bool = False) -> bool:
    """A boolean knob."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return parse_bool(raw, name=name)


def debug_enabled() -> bool:
    """``MPI4JAX_TPU_DEBUG``: per-call debug lines."""
    return flag("MPI4JAX_TPU_DEBUG")


def trace_path() -> Optional[str]:
    """``MPI4JAX_TPU_TRACE``: the recording's dump base path, or None
    (the recorder stays off)."""
    raw = os.environ.get("MPI4JAX_TPU_TRACE")
    return raw if raw else None


def uring_mode() -> str:
    """``MPI4JAX_TPU_URING`` as "auto" | "0" | "1" (read natively; parsed
    here for ``knob_env``)."""
    return _choice("MPI4JAX_TPU_URING", "auto", ("auto", "0", "1"))


def plan_spec() -> Optional[str]:
    """``MPI4JAX_TPU_PLAN``: a plan-file path or enable flag, or None when
    off (read afresh; ``runtime.planrt.plan_spec`` caches it for the
    ops' path and the bridge's install gate)."""
    raw = os.environ.get("MPI4JAX_TPU_PLAN", "").strip()
    if not raw or raw.lower() in ("0", "false", "off", "no"):
        return None
    return raw


def elastic_enabled() -> bool:
    """``MPI4JAX_TPU_ELASTIC`` (default False): the bridge's abort raises
    ``elastic.RankFailure`` instead of exiting the process."""
    return flag("MPI4JAX_TPU_ELASTIC")


def elastic_dir() -> Optional[str]:
    """``MPI4JAX_TPU_ELASTIC_DIR``: the launcher's coordination directory
    for generation announcements, or None."""
    raw = os.environ.get("MPI4JAX_TPU_ELASTIC_DIR")
    return raw if raw else None


def elastic_policy() -> str:
    """``MPI4JAX_TPU_ELASTIC_POLICY`` as "shrink" | "respawn", strict: a
    typo must not shrink a job whose operator asked for respawn."""
    return _choice("MPI4JAX_TPU_ELASTIC_POLICY", "shrink",
                   ("shrink", "respawn"))


def elastic_grace_s() -> float:
    """``MPI4JAX_TPU_ELASTIC_GRACE_S`` in seconds (default 60; a
    non-positive value means the default)."""
    v = _float_knob("MPI4JAX_TPU_ELASTIC_GRACE_S", 60.0)
    return v if v > 0 else 60.0


def generation() -> int:
    """``MPI4JAX_TPU_GENERATION``: the world generation this process was
    born into (default 0).  ``elastic.current_generation`` tracks the live
    one from there."""
    raw = os.environ.get("MPI4JAX_TPU_GENERATION")
    if raw is None or not raw.strip():
        return 0
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"cannot parse MPI4JAX_TPU_GENERATION={raw!r} as an integer")


def host_address() -> str:
    """``MPI4JAX_TPU_HOST``: this rank's reachable address, which
    ``WorldComm.from_mpi`` shares with its peers (default 127.0.0.1)."""
    return os.environ.get("MPI4JAX_TPU_HOST", "127.0.0.1")


def ckpt_dir() -> Optional[str]:
    """``MPI4JAX_TPU_CKPT_DIR``: the default sharded-checkpoint directory,
    or None (callers must pass one explicitly)."""
    raw = os.environ.get("MPI4JAX_TPU_CKPT_DIR")
    return raw if raw else None


def tune_model_path() -> Optional[str]:
    """``MPI4JAX_TPU_TUNE_MODEL``: an explicit cost-model file path, or
    None."""
    raw = os.environ.get("MPI4JAX_TPU_TUNE_MODEL")
    return raw if raw and raw.strip() else None


def knob_env() -> dict:
    """The resolved tuning-relevant knobs, stamped into tune caches and
    ``obs.bench_record`` rows: the same keys and values as the JAX
    package's ``knob_env``."""
    return {
        "MPI4JAX_TPU_COLL_ALGO":
            os.environ.get("MPI4JAX_TPU_COLL_ALGO", "").strip(),
        "MPI4JAX_TPU_COLL_QUANT": quant_mode(),
        "MPI4JAX_TPU_HIER": hier_mode(),
        "MPI4JAX_TPU_ICI_LEG": ici_leg_mode(),
        "MPI4JAX_TPU_URING": uring_mode(),
        "MPI4JAX_TPU_PLAN": plan_spec() or "0",
    }
