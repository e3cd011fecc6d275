"""The world tier's bootstrap on the port, on the CPU.

- ``WorldComm.from_mpi`` with the repo's fake mpi4py
  (``tests/world_programs/_fake_mpi/``, a file rendezvous), the shape of
  ``tests/world_programs/mpi_adopt.py`` at np 2: two plain processes (this
  file is their program, no launcher) adopt ``COMM_WORLD``, a
  ``Split``-derived subgroup in reversed order, and compose the adopted
  world with the port's own ``split``; each comm carries its host list to
  the transport's init;
- the launcher's ``--hosts``: every rank sees ``MPI4JAX_TPU_HOSTS`` and
  its world runs on it; a count that differs from ``-n`` fails, as in the
  JAX launcher;
- ``runtime.distributed``: ``initialize`` has nothing to do in one process
  and raises beyond it; ``global_mesh`` is ``make_mesh``.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_MPI = os.path.join(REPO, "tests", "world_programs", "_fake_mpi")


def _adopt():
    """One process of the from_mpi job."""
    from mpi4py import MPI  # the fake harness

    import mpi4jax_tpu_torch as mt
    from mpi4jax_tpu_torch.runtime.transport import WorldComm

    torch.set_num_threads(1)
    world = WorldComm.from_mpi(MPI.COMM_WORLD, device="cpu")
    rank, size = world.rank(), world.size()
    assert (rank, size) == (MPI.COMM_WORLD.Get_rank(),
                            MPI.COMM_WORLD.Get_size())
    assert world._hosts == ",".join(["127.0.0.1"] * size)
    out = mt.allreduce(torch.arange(4.0) + rank, op=mt.SUM, comm=world)
    assert out.tolist() == (size * torch.arange(4.0)
                            + sum(range(size))).tolist()
    with world:  # the adopted comm as the ambient default
        got = mt.bcast(mt.allreduce(torch.ones(8) * (rank + 1)) * 2.0,
                       root=size - 1)
    assert got.tolist() == [2.0 * sum(range(1, size + 1))] * 8

    # a Split-derived subgroup, its ranks in reversed order, becomes its
    # own world
    sub_mpi = MPI.COMM_WORLD.Split(color=0, key=size - rank)
    sub = WorldComm.from_mpi(sub_mpi, device="cpu")
    assert (sub.rank(), sub.size()) == (size - 1 - rank, size)
    ranks = mt.allgather(torch.tensor(float(rank)), comm=sub)
    assert ranks.tolist() == [float(r) for r in reversed(range(size))]

    # the adopted world composes with the port's own split and dup
    own = world.split(color=rank // 2, key=rank)
    assert mt.allreduce(torch.tensor(1.0), op=mt.SUM,
                        comm=own).item() == own.size()
    dup = world.dup()
    assert mt.allreduce(torch.tensor(float(rank)), op=mt.MAX,
                        comm=dup).item() == size - 1
    print(f"from_mpi OK r{rank}", flush=True)


def _hosts_rank():
    """One rank of the --hosts job."""
    import mpi4jax_tpu_torch as mt
    from mpi4jax_tpu_torch.runtime import transport

    torch.set_num_threads(1)
    comm = transport.get_world_comm(device="cpu")
    total = mt.allreduce(torch.tensor(float(comm.rank() + 1)), op=mt.SUM,
                         comm=comm)
    print(f"rank {comm.rank()} hosts={os.environ['MPI4JAX_TPU_HOSTS']} "
          f"sum={total.item():g}", flush=True)


def test_from_mpi_with_the_fake_mpi4py(tmp_path):
    env = dict(os.environ, FAKE_MPI_DIR=str(tmp_path), FAKE_MPI_SIZE="2",
               PYTHONPATH=os.pathsep.join([REPO, FAKE_MPI]))
    for var in ("MPI4JAX_TPU_COORD", "MPI4JAX_TPU_RANK", "MPI4JAX_TPU_SIZE",
                "MPI4JAX_TPU_HOSTS"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "adopt"],
        env=dict(env, FAKE_MPI_RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:] + out
        assert f"from_mpi OK r{r}" in out


def test_launch_hosts_exports_the_host_list(monkeypatch, capfd):
    from mpi4jax_tpu_torch.runtime import launch

    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.delenv("MPI4JAX_TPU_HOSTS", raising=False)
    rc = launch.main(["-n", "2", "--hosts", "127.0.0.1,127.0.0.1",
                      "--timeout", "60", os.path.abspath(__file__),
                      "hosts"])
    out = capfd.readouterr().out
    assert rc == 0, out
    for r in range(2):
        assert f"rank {r} hosts=127.0.0.1,127.0.0.1 sum=3" in out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_launch_hosts_count_must_match(package, capsys):
    if package == "port":
        from mpi4jax_tpu_torch.runtime import launch
    else:
        from mpi4jax_tpu.runtime import launch
    with pytest.raises(SystemExit) as err:
        launch.main(["-n", "2", "--hosts", "127.0.0.1", "prog.py"])
    assert err.value.code == 2
    assert "--hosts lists 1 entries for 2 ranks" in capsys.readouterr().err


def test_launch_help_names_hosts_and_leaves_out_platform(capsys):
    from mpi4jax_tpu_torch.runtime import launch

    with pytest.raises(SystemExit):
        launch.main(["--help"])
    text = capsys.readouterr().out
    assert "--hosts" in text and "MPI4JAX_TPU_HOSTS" in text
    assert "--platform" in text  # named in the help: no torch meaning
    with pytest.raises(SystemExit):
        launch.main(["-n", "2", "--platform", "cpu", "prog.py"])


def test_distributed_initialize_and_global_mesh(monkeypatch):
    from mpi4jax_tpu_torch.parallel.mesh import MeshComm
    from mpi4jax_tpu_torch.runtime import distributed

    assert distributed.initialize() is None
    assert distributed.initialize(num_processes=1, process_id=0) is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 8"):
        distributed.initialize("localhost:1234", num_processes=2,
                               process_id=0)
    mesh = distributed.global_mesh(axis="x", device="cpu")
    assert isinstance(mesh, MeshComm)
    assert mesh.axes == ("x",) and mesh.size() == 1
    assert mesh.device == torch.device("cpu")


def test_from_mpi_and_host_knobs(monkeypatch):
    from mpi4jax_tpu_torch.utils import config

    monkeypatch.delenv("MPI4JAX_TPU_HOST", raising=False)
    assert config.host_address() == "127.0.0.1"
    monkeypatch.setenv("MPI4JAX_TPU_HOST", "10.1.2.3")
    assert config.host_address() == "10.1.2.3"


if __name__ == "__main__":
    {"adopt": _adopt, "hosts": _hosts_rank}[sys.argv[1]]()
