"""World reconstruction after a rank failure.

The counterpart of ``mpi4jax_tpu/elastic/_world.py``, with its protocol.
The elastic launcher (``runtime/launch.py --elastic``) supervises the rank
group.  When a rank dies it announces a new world *generation*: an
atomically written ``gen_<n>.json`` in ``MPI4JAX_TPU_ELASTIC_DIR`` with
the member map (launcher *slot* -> dense new rank, -1 for a lost slot),
the new world size and a re-derived base port.  Surviving ranks catch
:class:`RankFailure`, call :func:`recover`, and

1. wait (at most ``MPI4JAX_TPU_ELASTIC_GRACE_S``) for the next
   announcement;
2. look up their new rank by their launcher slot (slots never renumber,
   so the maps of consecutive generations compose);
3. rebuild the native communicator over the survivors through
   ``tpucomm_shrink`` (``bridge.rebuild``: the dead world's topology
   sub-comms and live controller go first, then the shrink, then the
   per-world setup: topology, tune, recorder, live, and the plan re-proved
   for the new size) and rebind the process's ``WorldComm`` in place.

Renumbering is dense, so a schedule the static verifier proved for any
world size stays valid on the shrunk world.  Under the ``respawn`` policy
the announcement keeps the size and an identity map, and the launcher
restarts the dead slot's program, which joins the new bootstrap through a
plain ``comm_init`` (its environment carries the generation and the new
coordinates).
"""

from __future__ import annotations

import json
import os
import sys
import time

from ..utils import config
from ._errors import RankFailure

#: the live world generation of this process: the one it was born into
#: (``MPI4JAX_TPU_GENERATION``, 0 for the original world), advanced by
#: every successful recover()
_generation = None

#: the newest generation this process tried to join (a failed bootstrap
#: must not target the same announcement again)
_last_attempted = None


def current_generation() -> int:
    """The world generation this process currently belongs to."""
    global _generation
    if _generation is None:
        _generation = config.generation()
    return _generation


def my_slot() -> int:
    """This process's launcher slot (``MPI4JAX_TPU_SLOT``, else the rank it
    was spawned with, ``MPI4JAX_TPU_RANK``).  A respawned rank may
    bootstrap with another dense rank, so the launcher gives it its slot
    separately."""
    raw = os.environ.get("MPI4JAX_TPU_SLOT",
                         os.environ.get("MPI4JAX_TPU_RANK"))
    if raw is None:
        raise RuntimeError(
            "not a world-tier rank (MPI4JAX_TPU_RANK unset); elastic "
            "recovery needs the launcher")
    return int(raw)


def _gen_path(gen_dir: str, n: int) -> str:
    return os.path.join(gen_dir, f"gen_{int(n)}.json")


def read_generation(gen_dir: str, n: int):
    """The generation-``n`` announcement, or None when it is not (fully)
    written yet."""
    try:
        with open(_gen_path(gen_dir, n)) as f:
            spec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if int(spec.get("generation", -1)) != int(n):
        return None
    return spec


def wait_for_generation(n: int, *, grace_s=None, gen_dir=None):
    """Poll the coordination directory until a generation >= ``n`` is
    announced; returns the newest announcement (deaths can outpace
    recoveries: a survivor joins the latest membership).  Raises
    :class:`RankFailure` when the grace period runs out."""
    gen_dir = gen_dir or config.elastic_dir()
    if gen_dir is None:
        raise RuntimeError(
            "MPI4JAX_TPU_ELASTIC_DIR unset: elastic recovery needs the "
            "launcher's --elastic mode (or an explicit gen_dir)")
    grace_s = config.elastic_grace_s() if grace_s is None else grace_s
    deadline = time.monotonic() + grace_s
    while True:
        newest = None
        k = int(n)
        while True:
            spec = read_generation(gen_dir, k)
            if spec is None:
                break
            newest = spec
            k += 1
        if newest is not None:
            return newest
        if time.monotonic() >= deadline:
            raise RankFailure(
                f"no generation >= {n} announced within {grace_s:g} s "
                f"(MPI4JAX_TPU_ELASTIC_GRACE_S) in {gen_dir}; giving up",
                op="recover")
        time.sleep(0.05)


class Recovery:
    """What one successful :func:`recover` produced."""

    def __init__(self, *, generation, world, rank, size, old_to_new,
                 lost, policy, base_port):
        self.generation = int(generation)
        self.world = world            # the rebound WorldComm
        self.rank = int(rank)         # this process's new dense rank
        self.size = int(size)
        self.old_to_new = dict(old_to_new)  # slot -> new rank (-1 = lost)
        self.lost = list(lost)              # slots lost so far
        self.policy = policy
        self.base_port = int(base_port)

    def __repr__(self):
        return (f"Recovery(gen={self.generation}, rank={self.rank}/"
                f"{self.size}, lost={self.lost}, policy={self.policy})")


def recover(world=None, *, grace_s=None) -> Recovery:
    """Rebuild the world communicator over the surviving ranks.

    Call after catching :class:`RankFailure` (or anything
    :func:`is_rank_failure` recognizes).  Blocks until the launcher
    announces the next generation, then runs the native shrink bootstrap
    and rebinds ``world`` (default: the process's world comm) in place.
    Raises :class:`RankFailure` again when this process was declared lost,
    the announcement never comes, or the rebuilt bootstrap fails: the
    caller may retry (a newer generation supersedes a failed one) or let
    it propagate (the launcher then counts this rank lost and announces
    another generation to the rest).
    """
    global _generation, _last_attempted
    from ..runtime import bridge, transport

    if world is None:
        world = transport.get_world_comm()
    slot = my_slot()
    cur = current_generation()
    if _last_attempted is not None:
        cur = max(cur, _last_attempted)
    # a recovery must not dial a peer that never comes without a deadline;
    # an operator's explicit setting wins
    os.environ.setdefault("MPI4JAX_TPU_CONNECT_TIMEOUT_S", "30")
    spec = wait_for_generation(cur + 1, grace_s=grace_s)
    gen = int(spec["generation"])
    _last_attempted = gen
    mapping = {int(k): int(v) for k, v in spec.get("map", {}).items()}
    new_rank = mapping.get(slot, -1)
    if new_rank < 0:
        raise RankFailure(
            f"slot {slot} was declared lost in generation {gen} "
            "(the launcher presumed this rank dead)", op="recover")
    new_size = int(spec["size"])
    base_port = int(spec["base_port"])
    hosts = spec.get("hosts", "") or ""
    # processes started from here on, and the recorder re-armed inside the
    # rebuild, see the new generation
    os.environ["MPI4JAX_TPU_GENERATION"] = str(gen)
    handle = bridge.rebuild(world._handle, new_rank, new_size, base_port,
                            hosts, device=world.device)
    host = hosts.split(",")[0] if hosts else "127.0.0.1"
    world._rebind(new_rank, new_size, f"{host}:{base_port}", handle)
    _generation = gen
    # the launcher forwards rank stderr and greps these lines
    print(f"[elastic] slot {slot}: recovered into generation {gen} as "
          f"rank {new_rank}/{new_size} (lost slots: {spec.get('lost')})",
          file=sys.stderr, flush=True)
    return Recovery(
        generation=gen, world=world, rank=new_rank, size=new_size,
        old_to_new=mapping, lost=spec.get("lost", []),
        policy=spec.get("policy", "shrink"), base_port=base_port)
