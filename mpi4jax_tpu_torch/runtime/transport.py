"""The world tier's communicator: one process per rank.

The counterpart of ``mpi4jax_tpu/runtime/transport.py`` (``WorldComm``,
``:142``; ``_detect_rank_size``, ``:44``; ``get_world_comm``, ``:76``;
``_free_port_block``, ``:95``).  A job is started by
``python -m mpi4jax_tpu_torch.runtime.launch -n N prog.py``, which sets
``MPI4JAX_TPU_RANK`` / ``MPI4JAX_TPU_SIZE`` / ``MPI4JAX_TPU_COORD`` for
each rank; mpirun, PMI and srun environments are adopted as there.

A ``WorldComm`` has a ``device``: where the tensors that its ops take and
return live, ``cuda:0`` unless the caller passes ``device="cpu"``.  Its
data crosses the native transport through pinned host memory (the
reference's GPU bridge pattern, ``ops/_world_impl.py``), and the
intra-island leg of its hierarchical allreduce runs its kernels on that
device.  ``split`` and ``dup`` make sub-communicators that borrow the
world's sockets.  ``WorldComm.from_mpi`` adopts an mpi4py communicator
(``:318-345`` there): mpi4py only bootstraps, the data moves over the
native transport.  ``WorldComm._rebind`` (``:175-190`` there) moves the
world comm onto a rebuilt communicator after an elastic recovery.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from ..parallel.mesh import CommBase
from ..utils.device import resolve_device

ENV_RANK = "MPI4JAX_TPU_RANK"
ENV_SIZE = "MPI4JAX_TPU_SIZE"
ENV_COORD = "MPI4JAX_TPU_COORD"

# foreign launchers, in order; the launcher's own variables win
_FOREIGN_RANK_SIZE = (
    (ENV_RANK, ENV_SIZE),
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),  # Open MPI mpirun
    ("PMI_RANK", "PMI_SIZE"),                          # MPICH / PMI-1
    ("SLURM_PROCID", "SLURM_NTASKS"),                  # srun
)


def _detect_rank_size():
    """(rank, size) from the first launcher environment present, else
    None.  The SLURM pair counts only with ``SLURM_LAUNCH_NODE_IPADDR``,
    which srun-launched tasks carry and plain batch steps do not."""
    for rank_var, size_var in _FOREIGN_RANK_SIZE:
        if rank_var in os.environ and size_var in os.environ:
            if (rank_var == "SLURM_PROCID"
                    and "SLURM_LAUNCH_NODE_IPADDR" not in os.environ):
                continue
            return int(os.environ[rank_var]), int(os.environ[size_var])
    return None


class _VirtualRank(threading.local):
    """The static verifier's rank threads (``analysis/_sim.py``) each set
    their ``AbstractComm`` here: ``get_world_comm`` hands it out, as the
    launcher's environment gives a real rank its comm."""

    def __init__(self):
        self.comm = None


_virtual = _VirtualRank()


def in_world() -> bool:
    """True when this process was launched as a rank of a world job (or
    this thread is a rank of the static verifier's virtual world)."""
    return _virtual.comm is not None or _detect_rank_size() is not None


_world: Optional["WorldComm"] = None


def get_world_comm(device=None) -> "WorldComm":
    """This process's world communicator, made on the first call on
    ``device`` (default ``cuda:0``); a later call that names another
    device raises.  In a rank thread of the static verifier, that rank's
    ``AbstractComm``."""
    global _world
    if _virtual.comm is not None:
        return _virtual.comm.bind_device(device)
    if _world is None:
        rs = _detect_rank_size()
        if rs is None:
            raise RuntimeError(
                "not running under a world launcher; start with "
                "`python -m mpi4jax_tpu_torch.runtime.launch -n <ranks> "
                "prog.py` (or mpirun/srun), or use the mesh tier "
                "(make_mesh) in a single process")
        _world = WorldComm(rank=rs[0], size=rs[1],
                           coord=os.environ.get(ENV_COORD)
                           or "127.0.0.1:49817", device=device)
    elif device is not None and resolve_device(device) != _world.device:
        raise ValueError(f"the world comm lives on {_world.device}, not "
                         f"{resolve_device(device)}")
    return _world


def _free_port_block(size: int) -> int:
    """A base port such that base .. base+size-1 are bindable on this host
    (rank r listens on base+r; a collision on another host surfaces as the
    native init's failure)."""
    import random
    import socket

    for _ in range(50):
        base = random.randrange(42000, 48000)
        ok = True
        for off in range(max(size, 1)):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                s.bind(("127.0.0.1", base + off))
            except OSError:
                ok = False
            finally:
                s.close()
            if not ok:
                break
        if ok:
            return base
    raise RuntimeError(f"no free block of {size} ports found")


class WorldComm(CommBase):
    """One-process-per-rank communicator over the native transport.

    The native comm is connected on first use of ``handle`` (collective:
    every rank connects, then discovers the topology)."""

    def __init__(self, rank: int, size: int, coord: str, *, device=None,
                 handle=None, parent=None, hosts=None):
        self._rank = int(rank)
        self._size = int(size)
        self._coord = coord
        self._hosts = hosts  # per-rank host table (else MPI4JAX_TPU_HOSTS)
        self._handle = handle
        self._parent = parent  # children borrow the parent's sockets
        self.device = resolve_device(device)

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._size

    @property
    def handle(self) -> int:
        """The native communicator (connects on first use, then installs
        the tune layers, ``tune.install``, and arms the recorder when
        ``MPI4JAX_TPU_TRACE`` is set, ``bridge.comm_init``)."""
        if self._handle is None:
            from . import bridge

            self._handle = bridge.comm_init(self._rank, self._size,
                                            self._coord,
                                            device=self.device,
                                            hosts=self._hosts)
        return self._handle

    def _rebind(self, rank: int, size: int, coord: str, handle) -> None:
        """Elastic recovery (``elastic.recover``) rebinds this comm onto the
        rebuilt native communicator in place, so every held reference
        keeps working across the shrink, on the same ``device``.  Only the
        world comm rebinds: a sub-communicator borrowed the dead world's
        sockets and is split again on the recovered world."""
        if self._parent is not None:
            raise RuntimeError("only the world communicator is "
                               "rebindable; re-split sub-comms on the "
                               "recovered world")
        self._rank = int(rank)
        self._size = int(size)
        self._coord = coord
        self._handle = handle

    @classmethod
    def from_mpi(cls, mpi_comm, *, device=None) -> "WorldComm":
        """Adopt an mpi4py communicator (``MPI.COMM_WORLD`` or one derived
        with ``Split``): its group becomes a fresh world over the native
        transport.

        mpi4py only bootstraps: the rank and size, the members' addresses
        (``MPI4JAX_TPU_HOST``, default 127.0.0.1, allgathered) and a base
        port that rank 0 finds free and broadcasts.  The comm carries that
        host list down to the transport's init, so it needs no
        ``MPI4JAX_TPU_HOSTS``.  Collective over ``mpi_comm``: every member
        calls it at the same point.  The result composes with ``split``
        and ``dup`` as any world comm does.  ``device`` as in
        ``get_world_comm``.
        """
        from ..utils import config

        rank = mpi_comm.Get_rank()
        size = mpi_comm.Get_size()
        hosts = mpi_comm.allgather(config.host_address())
        base_port = mpi_comm.bcast(
            _free_port_block(size) if rank == 0 else None, root=0)
        return cls(rank=rank, size=size, coord=f"{hosts[0]}:{base_port}",
                   device=device, hosts=",".join(hosts))

    def dup(self) -> "WorldComm":
        """Collective: a comm of the same ranks with its own message
        space."""
        from . import bridge

        return WorldComm(self._rank, self._size, self._coord,
                         device=self.device, handle=bridge.dup(self.handle),
                         parent=self)

    def split(self, color: int, key=None):
        """Collective: ranks sharing ``color`` form a new communicator,
        ordered by ``(key, parent rank)``; ``color < 0`` opts out and
        returns None."""
        from . import bridge

        key = self._rank if key is None else int(key)
        handle = bridge.split(self.handle, int(color), key)
        if handle is None:
            return None
        return WorldComm(bridge.comm_rank(handle), bridge.comm_size(handle),
                         self._coord, device=self.device, handle=handle,
                         parent=self)

    def finalize(self) -> None:
        """Close this comm's native communicator, if it was ever
        connected (collective: every member calls it at the same point)."""
        if self._handle is not None:
            from . import bridge

            bridge.comm_finalize(self._handle)
            self._handle = None

    def topology(self):
        """The discovered :class:`~mpi4jax_tpu_torch.topo.Topology` of
        this world comm, or None (flat, ``MPI4JAX_TPU_TOPO=off``, or a
        sub-communicator)."""
        from .. import topo

        return topo.get_topology(self.handle)

    def coll_algo(self, op: str, nbytes: int) -> str:
        """The algorithm the engine would run for ``op`` ("allreduce",
        "allgather" or "alltoall") at ``nbytes`` on this comm: "shm" when
        the same-host arena serves it, else the installed table's pick
        after the gates (``tune``)."""
        from .. import tune
        from . import bridge

        code = bridge.coll_algo_for(self.handle, tune.OP_KIND[op],
                                    int(nbytes))
        return tune.ALGO_NAMES.get(code, "auto")

    def __repr__(self):
        kind = "WorldComm" if self._parent is None else "SubComm"
        return (f"{kind}(rank={self._rank}, size={self._size}, "
                f"device={self.device})")
