"""Abstract communicators for analysis: the shape of a WorldComm with no
transport behind it.

The counterpart of ``mpi4jax_tpu/analysis/_fake.py``.  An
:class:`AbstractComm` carries rank, size and lineage, so every op-layer
code path (validation, the fronts' rank-dependent results such as
``gather``'s) behaves exactly as in a run, but touching the native handle
is an error: analysis never opens a socket or a shared-memory segment and
never loads the native library.

``check`` uses one AbstractComm per simulated rank.  The virtual world
(``_sim.py``) attaches its session, so that ``split`` and ``dup``
rendezvous across the rank threads, and the comm answers what a program
reads of a live world comm without the transport: its ``device`` (the one
the program asks ``get_world_comm`` for), its ``topology()`` (built from
the fingerprints every rank of this host would allgather, so
``MPI4JAX_TPU_FAKE_HOSTS`` islands hold), and ``coll_algo``, which names
the virtual world's exact service: ``"analysis"``.
"""

from __future__ import annotations

import torch

from ..runtime.transport import WorldComm


class AnalysisError(RuntimeError):
    """The analyzed program attempted something analysis cannot allow
    (e.g. touching the native transport)."""


def _default_device() -> torch.device:
    # the comm of a program that never names its device: the card when
    # there is one, as an entry point's default
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class AbstractComm(WorldComm):
    """A WorldComm stand-in for one simulated rank.

    ``key`` plays the lineage role (identical across the comm's members,
    so events on it agree rank to rank exactly as a run's comms do);
    ``members`` is the world-rank tuple ordered by sub-rank.
    """

    def __init__(self, rank, size, *, key=(0,), members=None, session=None,
                 device=None):
        self._rank = int(rank)
        self._size = int(size)
        self._coord = "analysis:virtual"
        self._hosts = None
        self._handle = None
        self._parent = None
        self._lineage = tuple(key)
        self._split_seq = 0
        self._members = tuple(members) if members is not None \
            else tuple(range(size))
        self._session = session
        self.device = torch.device(device) if device is not None \
            else _default_device()
        self._device_named = device is not None

    @property
    def key(self):
        return self._lineage

    @property
    def members(self):
        return self._members

    @property
    def handle(self):
        raise AnalysisError(
            "an op reached the native transport during static analysis — "
            "this is a bug in mpi4jax_tpu_torch.analysis (no live "
            "communication may happen here)"
        )

    def bind_device(self, device):
        """The comm a program's ``get_world_comm(device)`` gets: the first
        device named fixes the comm's, a later different one raises, as on
        a live world comm."""
        if device is None:
            return self
        from ..utils.device import resolve_device

        dev = resolve_device(device)
        if not self._device_named:
            self.device = dev
            self._device_named = True
        elif dev != self.device:
            raise ValueError(f"the world comm lives on {self.device}, not "
                             f"{dev}")
        return self

    def split(self, color, key=None):
        if self._session is None:
            raise NotImplementedError(
                "comm.split() inside analysis.check() is not supported: a "
                "split's membership depends on every rank's color, which a "
                "per-rank run cannot see.  Analyze the full program "
                "instead: python -m mpi4jax_tpu_torch.analyze prog.py "
                "--np N"
            )
        return self._session.split_collective(self, int(color), key)

    def dup(self):
        if self._session is None:
            raise NotImplementedError(
                "comm.dup() inside analysis.check() is not supported; "
                "analyze the full program via python -m "
                "mpi4jax_tpu_torch.analyze instead"
            )
        return self._session.dup_collective(self)

    clone = dup
    Clone = dup
    Split = split

    def topology(self):
        """The topology every rank of this host would discover (the
        world's only, as on a live comm; None for a sub-communicator or
        under ``MPI4JAX_TPU_TOPO=off``)."""
        from .. import topo
        from ..utils import config

        if self._lineage != (0,) or self._size < 2 \
                or config.topo_mode() == "off":
            return None
        return topo.build_topology([
            topo.local_fingerprint(r, self._size, self.device)
            for r in range(self._size)])

    def coll_algo(self, op: str, nbytes: int) -> str:
        return "analysis"

    def __repr__(self):
        return (f"AbstractComm(rank={self._rank}, size={self._size}, "
                f"key={self._lineage})")
