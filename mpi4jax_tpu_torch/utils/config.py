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
  ``parallel/dp.py``, in KiB.

Plan execution (``MPI4JAX_TPU_PLAN``) is not ported; the port treats it as
off.
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
    gradient bucketing; a negative value counts as 0)."""
    raw = os.environ.get("MPI4JAX_TPU_PLAN_BUCKET_KB")
    if raw is None or not raw.strip():
        return 1 << 20
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"cannot parse MPI4JAX_TPU_PLAN_BUCKET_KB={raw!r} as KB")
    return max(0, v) * 1024
