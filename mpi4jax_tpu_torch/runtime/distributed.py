"""Multi-process initialization helpers.

The counterpart of ``mpi4jax_tpu/runtime/distributed.py``.  There
``initialize`` wires the controllers of a multi-host JAX program
(``jax.distributed.initialize``) and ``global_mesh`` spans every device of
every host.  The port's mesh tier lives in one process on one device, so
a single-process job has nothing to initialize, and ``global_mesh`` is
``make_mesh``.  A mesh across processes needs ranks on several devices
first (ROADMAP.md §1 item 8); until then ``initialize`` with more than one
process raises.  The world tier (one process per rank, ``runtime.launch``,
``MPI4JAX_TPU_HOSTS``) is how the port runs across processes and hosts.
"""

from __future__ import annotations

from typing import Optional


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kwargs) -> None:
    """Nothing to do for a single-process job (``num_processes`` None or
    1), as ``jax.distributed.initialize`` effectively does there; more
    processes raise ``NotImplementedError``."""
    del coordinator_address, process_id, kwargs
    if num_processes is not None and int(num_processes) > 1:
        raise NotImplementedError(
            f"a mesh across {num_processes} processes needs ranks on "
            "several devices, which the port does not run yet (ROADMAP.md "
            "§1 item 8); use the world tier (python -m "
            "mpi4jax_tpu_torch.runtime.launch) for one process per rank")


def global_mesh(axis: str = "mpi", device=None):
    """A 1-D mesh over every device of the job: ``make_mesh(axis=axis)``
    (one device, one rank)."""
    from ..parallel.mesh import make_mesh

    return make_mesh(axis=axis, device=device)
