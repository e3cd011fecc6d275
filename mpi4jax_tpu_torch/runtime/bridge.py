"""ctypes binding of the native transport, for the port's world tier.

The counterpart of ``mpi4jax_tpu/runtime/bridge.py``: comm creation and
its topology (``comm_init``, ``split``, ``dup``, ``comm_finalize``), the
default decision table's install (``set_coll_table``, pushed by
``tune.install`` at comm creation), every world op on contiguous numpy
buffers (``send``, ``recv``, ``recv_status``, ``sendrecv``,
``sendrecv_status``, ``shift2``, ``barrier``, ``bcast``, ``reduce``,
``scan``, ``gather``, ``scatter``, ``allgather``, ``alltoall`` and
``allreduce``, each collective with its forced-algorithm entry where the
transport has one), the leg's hook in front of the native allreduce, and
the transport's own int8 codec (``quant_pack``).  The argument layouts and
output shapes are those of the JAX package's bridge (``:1103-1590``
there); a function that fills a result takes its buffer as ``out``, so the
world tier can hand in pinned host memory.  At comm creation the bridge
installs the tune layers (``tune.install``: the default table, the
persistent cache, the API and environment overrides) and, when
``MPI4JAX_TPU_TRACE`` is set or ``obs.start()`` ran, arms the recorder
after a clock-alignment handshake and schedules this rank's dump at
interpreter exit (``_install_obs``), as ``runtime/bridge.py:551-563,
833-880`` there; the native event ring's entry points are bound here and
decoded by ``obs/_native.py``.  ``MPI4JAX_TPU_DEBUG`` turns on the
transport's own debug lines (``tpucomm_set_logging``).

Two control-plane layers plug in here, as ``bridge.py:514-597, 808-829,
1029-1100, 1259-1546`` there:

- **plan execution** (``runtime/planrt.py``): the ticketed posts
  (``post_send``, ``post_recv_into``, ``post_recv``, ``wait_ticket``) put
  a descriptor on the progress engine without waiting, and ``comm_init``
  attaches the verified plan that ``MPI4JAX_TPU_PLAN`` names to the world
  comm;
- **live re-tuning** (``live/``): ``stage_coll_table``,
  ``commit_coll_tables`` and ``coll_epoch`` swap the decision table at an
  agreed boundary, and the boundary hook (``set_live_boundary``) runs
  exactly once at the top of every collective wrapper (``barrier``,
  ``bcast``, ``reduce``, ``scan``, ``gather``, ``scatter``,
  ``allgather_raw``, ``alltoall``, ``allreduce_raw``), with the comm's
  handle: the live layer counts only the world comm's.  ``comm_init`` arms
  it under ``MPI4JAX_TPU_LIVE=auto``; ``comm_finalize`` disarms it first.

The build.  The transport is ``native/tpucomm.cc``, built transport-only
(no XLA FFI) with the JAX package's flags (``bridge.py:45-52`` there) into
``build/mpi4jax_tpu_torch/libtpucomm-<hash>.so`` at first use; the hash
covers the compiled source, the header and the flags.  One change is made
to the source, in a generated copy under ``build/``: the anonymous struct
of the io_uring probe (``tpucomm.cc:1384-1387``) puts a struct with a
flexible array member, ``io_uring_probe``, before another member, which
gcc 12 rejects ("flexible array member ... not at end of struct") with
newer kernel headers.  The copy replaces only that struct by one of the
same size and layout: a zeroed byte buffer of ``sizeof(io_uring_probe) +
64 * sizeof(io_uring_probe_op)`` bytes, read through a reference
``p`` to the header and a pointer ``ops`` to the 64 op slots that follow
it, so the code after it reads ``pr.p`` and ``pr.ops`` as before and the
probe syscall fills the same bytes.  The build fails loudly when that text
is not found; io_uring stays built in.  Concurrent ranks build once: a
file lock guards the build.

Fail-fast, as in the JAX package: a native call that fails prints
``tpucomm_<Op> returned error code N`` with the transport's reason,
poisons the peers' sockets and exits the process with code 1.  Under
``MPI4JAX_TPU_ELASTIC`` (``launch --elastic``) it raises
``elastic.RankFailure`` instead, after the same poisoning, so every
survivor reaches its recovery point; no setup step of a comm softens that
failure.  ``rebuild`` is recovery's native step (``bridge.py:754-806``
there): it tears down the dead world's topology sub-comms and live
controller, bootstraps the survivors through ``tpucomm_shrink``, reruns
the per-world setup that ``comm_init`` runs (``_post_init_setup``) and
re-proves the plan for the new size (``planrt.reinstall_after_rebuild``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils import config
from ..utils import dtypes as _dtypes

_REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO_ROOT / "native"
BUILD_DIR = _REPO_ROOT / "build" / "mpi4jax_tpu_torch"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
LINK_FLAGS = ["-lrt"]

# the one substitution of the generated copy (see the module docstring)
PROBE_STRUCT = """    struct {
      io_uring_probe p;   /* ops[0] flexible member lands on ops below */
      io_uring_probe_op ops[64];
    } pr{};"""
PROBE_BUFFER = """    struct {
      alignas(io_uring_probe) unsigned char raw[sizeof(io_uring_probe) +
                                                64 * sizeof(io_uring_probe_op)] = {};
      io_uring_probe& p = *reinterpret_cast<io_uring_probe*>(raw);
      io_uring_probe_op* ops =
          reinterpret_cast<io_uring_probe_op*>(raw + sizeof(io_uring_probe));
    } pr{};"""

#: native wire codes (native/tpucomm.h) of the f32 SUM that the leg takes
F32, SUM = 11, 0

_lib: Optional[ctypes.CDLL] = None


def patched_source() -> str:
    """``native/tpucomm.cc`` with the probe struct replaced; raises when
    the struct is not found exactly once."""
    src = (NATIVE_DIR / "tpucomm.cc").read_text()
    if src.count(PROBE_STRUCT) != 1:
        raise RuntimeError(
            "native/tpucomm.cc: the io_uring probe struct that the port's "
            "build replaces was not found exactly once; update "
            "mpi4jax_tpu_torch/runtime/bridge.py:PROBE_STRUCT")
    return src.replace(PROBE_STRUCT, PROBE_BUFFER)


def library_path() -> Path:
    """Where the transport built from the current source lives."""
    src = patched_source().encode()
    header = (NATIVE_DIR / "tpucomm.h").read_bytes()
    digest = hashlib.sha256(
        src + header + " ".join(CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtpucomm-{digest[:16]}.so"


def build() -> Path:
    """Build the transport if it is not built yet; returns its path.  A
    failed compile raises with g++'s messages."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtpucomm.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it meanwhile
            return target
        src = target.with_suffix(".cc")
        src.write_text(patched_source())
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, f"-I{NATIVE_DIR}",
               "-o", str(tmp), str(src), *LINK_FLAGS]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native transport failed:\n{proc.stdout}")
        os.replace(tmp, target)
    return target


def get_lib() -> ctypes.CDLL:
    """The loaded transport, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64, c_int, ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    for name, res, args in (
            ("tpucomm_init", i64, [c_int, c_int, c_int, ctypes.c_char_p]),
            ("tpucomm_finalize", None, [i64]),
            ("tpucomm_rank", c_int, [i64]),
            ("tpucomm_size", c_int, [i64]),
            ("tpucomm_split", i64, [i64, c_int, c_int]),
            ("tpucomm_set_topology", c_int,
             [i64, ctypes.POINTER(ctypes.c_int32), c_int, i64, i64]),
            ("tpucomm_dup", i64, [i64]),
            ("tpucomm_shm_info", c_int, [i64, i64p, i64p]),
            ("tpucomm_send", c_int, [i64, ptr, i64, c_int, c_int]),
            ("tpucomm_recv", c_int, [i64, ptr, i64, c_int, c_int]),
            ("tpucomm_recv_status", c_int,
             [i64, ptr, i64, c_int, c_int, i32p, i32p, i64p]),
            ("tpucomm_sendrecv", c_int,
             [i64, ptr, i64, c_int, ptr, i64, c_int, c_int]),
            ("tpucomm_sendrecv_status", c_int,
             [i64, ptr, i64, c_int, ptr, i64, c_int, c_int, c_int, i32p,
              i32p, i64p]),
            ("tpucomm_shift2", c_int,
             [i64, ptr, ptr, i64, c_int, c_int, c_int]),
            ("tpucomm_barrier", c_int, [i64]),
            ("tpucomm_bcast", c_int, [i64, ptr, i64, c_int]),
            ("tpucomm_gather", c_int, [i64, ptr, i64, ptr, c_int]),
            ("tpucomm_scatter", c_int, [i64, ptr, ptr, i64, c_int]),
            ("tpucomm_reduce", c_int,
             [i64, ptr, ptr, i64, c_int, c_int, c_int]),
            ("tpucomm_scan", c_int, [i64, ptr, ptr, i64, c_int, c_int]),
            ("tpucomm_allgather_algo", c_int, [i64, ptr, i64, ptr, c_int]),
            ("tpucomm_alltoall_algo", c_int,
             [i64, ptr, ptr, i64, c_int, c_int]),
            ("tpucomm_allreduce_algo", c_int,
             [i64, ptr, ptr, i64, c_int, c_int, c_int]),
            ("tpucomm_set_coll_table", None,
             [c_int, i64p, i32p, c_int]),
            ("tpucomm_coll_algo_for", c_int, [i64, c_int, i64]),
            ("tpucomm_quant_packed_bytes", i64, [i64]),
            ("tpucomm_quant_pack", c_int, [ptr, i64, c_int, ptr]),
            ("tpucomm_last_error", ctypes.c_char_p, []),
            ("tpucomm_abort_all", None, []),
            ("tpucomm_set_logging", None, [c_int]),
            ("tpucomm_obs_enable", None, [c_int, i64]),
            ("tpucomm_obs_counts", None, [i64p, i64p]),
            ("tpucomm_obs_drain", i64, [ptr, i64]),
            ("tpucomm_obs_peek", i64, [ptr, i64, i64p, i64p]),
            ("tpucomm_obs_clock", ctypes.c_double, []),
            ("tpucomm_link_counters", None, [i64p] * 6),
            ("tpucomm_uring_status", ctypes.c_char_p, [])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    # guarded like the JAX bridge's (``:152-157`` there): a library
    # without them reports plans and live re-tuning unavailable
    if hasattr(lib, "tpucomm_post"):
        lib.tpucomm_post.restype = i64
        lib.tpucomm_post.argtypes = [i64, ptr]
        lib.tpucomm_wait_ticket.restype = c_int
        lib.tpucomm_wait_ticket.argtypes = [i64, i64]
    if hasattr(lib, "tpucomm_shrink"):
        lib.tpucomm_shrink.restype = i64
        lib.tpucomm_shrink.argtypes = [i64, c_int, c_int, c_int,
                                       ctypes.c_char_p]
    if hasattr(lib, "tpucomm_commit_coll_tables"):
        lib.tpucomm_stage_coll_table.restype = None
        lib.tpucomm_stage_coll_table.argtypes = [c_int, i64p, i32p, c_int]
        lib.tpucomm_commit_coll_tables.restype = c_int
        lib.tpucomm_commit_coll_tables.argtypes = [i64, i64]
        lib.tpucomm_coll_epoch.restype = i64
        lib.tpucomm_coll_epoch.argtypes = []
    if config.debug_enabled():
        lib.tpucomm_set_logging(1)
    _lib = lib
    return lib


def _abort(opname: str, rc: int):
    lib = get_lib()
    text = (lib.tpucomm_last_error() or b"").decode(errors="replace")
    detail = f": {text}" if text else ""
    print(f"tpucomm_{opname} returned error code {rc}{detail}",
          file=sys.stderr, flush=True)
    # poison every peer socket so the group tears down within one deadline
    lib.tpucomm_abort_all()
    # elastic worlds: the same poisoning now carries every peer to its
    # recovery point, and this rank to its own (elastic.recover)
    if config.elastic_enabled():
        from ..elastic import RankFailure

        raise RankFailure(f"tpucomm_{opname} failed{detail}", op=opname)
    os._exit(1)


def _check(opname: str, rc: int):
    if rc != 0:
        _abort(opname, rc)


def _contig(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.flags.c_contiguous else a.copy(order="C")


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------- communicators and their topology ----------------

#: per world handle: the topology sub-comms' handles (finalized before the
#: world: they borrow its sockets) and their roles, which the leg reads
_topo_handles: dict = {}
_topo_subcomms: dict = {}


def comm_init(rank: int, size: int, coord: str, device=None,
              hosts=None) -> int:
    """Connect this rank's world comm (collective over the world), run
    its per-world setup (``_post_init_setup``) and return the native
    handle.  ``device`` is where the world's tensors live: the leg runs its
    kernels there.  ``hosts`` is the per-rank host list (comma-separated;
    default ``MPI4JAX_TPU_HOSTS``, else every rank on 127.0.0.1)."""
    lib = get_lib()
    _, _, port = coord.partition(":")
    if hosts is None:
        hosts = os.environ.get("MPI4JAX_TPU_HOSTS", "")
    handle = lib.tpucomm_init(rank, size, int(port or 49817), hosts.encode())
    if handle == 0:
        _abort("init", 1)
    try:
        _post_init_setup(lib, handle, rank, size, device, install_plan=True)
    except BaseException:
        _close_failed(handle)
        raise
    return handle


def _close_failed(handle) -> None:
    """Close a comm whose setup failed (a rank failure in elastic mode, a
    malformed knob): nothing keeps a handle that no comm holds."""
    _live_disarm(handle)
    _teardown_topology(handle)
    get_lib().tpucomm_finalize(handle)


def _post_init_setup(lib, handle, rank: int, size: int, device, *,
                     install_plan: bool) -> None:
    """The layers every fresh world gets, shared by ``comm_init`` and
    ``rebuild`` (``bridge.py:516-560`` there): topology discovery, the tune
    layers (``tune.install``), the recorder when asked (``_install_obs``),
    live re-tuning under ``MPI4JAX_TPU_LIVE=auto`` and, with
    ``install_plan``, the plan that ``MPI4JAX_TPU_PLAN`` names (a rebuilt
    world re-proves its plan in ``rebuild`` instead).  Collective.  A
    failure of a soft layer warns; a malformed knob and a rank failure
    propagate."""
    from .. import obs, tune

    topology = None
    if size > 1 and config.topo_mode() != "off":
        topology = _install_topology(lib, handle, rank, size, device)
    tune.install(size, topology=topology)
    # arming must agree across ranks: the alignment handshake is
    # collective (the launcher sets MPI4JAX_TPU_TRACE on every rank)
    if config.trace_path() is not None or obs.enabled():
        _install_obs(lib, handle, rank, size)
    # live re-tuning: arming must agree across ranks too (the rendezvous
    # bcasts at agreed boundaries); a malformed knob stays fatal, anything
    # else warns and the job runs untuned
    if config.live_mode() == "auto":
        try:
            from .. import live

            live.arm(lib, handle, rank, size)
        except ValueError:
            raise
        except Exception as e:  # a live-plane fault must not end the job
            from ..elastic import is_rank_failure

            if is_rank_failure(e):
                raise
            import warnings

            warnings.warn(f"live re-tuning arm failed: {e}")
    # plan execution: attach this rank's schedule of the verified plan
    # that MPI4JAX_TPU_PLAN names; a bad plan warns and the job runs the
    # ops as they come
    from . import planrt

    if install_plan and planrt.plan_spec() is not None:
        try:
            planrt.maybe_install_from_env(
                handle, rank, size,
                pin_memory=getattr(device, "type", None) == "cuda")
        except Exception as e:
            from ..elastic import is_rank_failure

            if is_rank_failure(e):
                raise
            import warnings

            warnings.warn(f"schedule-plan install failed: {e}")


_obs_dump_registered = False


def _install_obs(lib, handle, rank: int, size: int) -> None:
    """Align this rank's clock, arm the recorder and schedule the dump at
    interpreter exit.  Collective: a barrier, then every rank samples its
    unix clock and the samples are allgathered; the median minus the own
    sample is this rank's offset onto the job timeline.  It runs before
    the recorder starts, so its own ops are not recorded."""
    global _obs_dump_registered
    import time

    from .. import obs

    offset_s = 0.0
    if size > 1:
        barrier(handle)
        t_local = time.time()
        all_t = np.sort(allgather(handle, np.array([t_local], np.float64),
                                  size).ravel())
        offset_s = float(all_t[size // 2]) - t_local
    obs.start(lib=lib, rank=rank, size=size, clock_offset_s=offset_s)
    if not _obs_dump_registered:
        _obs_dump_registered = True
        import atexit

        atexit.register(_dump_obs_at_exit)


def _dump_obs_at_exit() -> None:
    base = config.trace_path()
    if base is None:
        return
    try:
        from .. import obs

        path = obs.dump(base)
        print(f"[obs] recording written to {path}", file=sys.stderr,
              flush=True)
    except Exception as e:  # a failed dump must not mask the exit code
        print(f"[obs] recording dump failed: {e}", file=sys.stderr,
              flush=True)


def _install_topology(lib, handle, rank: int, size: int, device):
    """Discovery, the sub-comms of a multi-island world, and the native
    install of the map.  Collective.  Returns the Topology, or None when
    discovery failed (the comm then stays flat, with a warning)."""
    from .. import topo

    try:
        t = topo.discover(handle, rank, size, device)
    except RuntimeError as e:
        # a peer dying mid-handshake is the elastic failure it is; only a
        # discovery-layer problem leaves the comm flat
        from ..elastic import is_rank_failure

        if is_rank_failure(e):
            raise
        import warnings

        warnings.warn(f"topology discovery failed; transport stays flat: "
                      f"{e}")
        return None
    intra_h = leader_h = None
    if t.multi:
        # both splits are collective over the world: every rank calls both
        my_island = t.island_of[rank]
        intra_h = split(handle, my_island, rank)
        leader_h = split(handle, 0 if rank == t.leaders[my_island] else -1,
                         rank)
        if len(t.islands[my_island]) == 1 and intra_h is not None:
            # a singleton island's intra comm is never used
            comm_finalize(intra_h)
            intra_h = None
    arr = (ctypes.c_int32 * size)(*t.island_of)
    if lib.tpucomm_set_topology(handle, arr, size, intra_h or 0,
                                leader_h or 0) != 0:
        import warnings

        warnings.warn("native topology install was rejected; hierarchical "
                      "schedules stay degraded to their flat twins")
    subs = [h for h in (intra_h, leader_h) if h is not None]
    if subs:
        _topo_handles[int(handle)] = subs
        _topo_subcomms[int(handle)] = {
            "topology": t, "rank": rank, "island": t.island_of[rank],
            "intra": intra_h, "leader": leader_h, "device": device,
        }
    topo._register(handle, t)
    return t


# ---------------- live re-tuning: the boundary hook ----------------

#: the live layer's hook, called with the comm's handle at the top of every
#: collective wrapper; None (the default) costs one global read per call
_live_boundary = None


def set_live_boundary(fn) -> None:
    """Install (or with None clear) the collective-boundary hook."""
    global _live_boundary
    _live_boundary = fn


def _live_disarm(handle=None) -> None:
    """Stop the live controller and clear the hook, if armed: a closing
    world's hook must not rendezvous on a dead handle.  ``handle``
    restricts it to that comm's controller."""
    if _live_boundary is None:
        return
    try:
        from .. import live

        live.disarm(handle=handle)
    except Exception:  # teardown goes on whatever the live layer says
        set_live_boundary(None)


def stage_coll_table(coded_table) -> bool:
    """Park candidate decision tables (``{op_kind: [(min_bytes,
    algo_code), ...]}``) in the native staging slots without touching
    dispatch; False when the library predates them."""
    lib = get_lib()
    if not hasattr(lib, "tpucomm_stage_coll_table"):
        return False
    _push_tables(lib.tpucomm_stage_coll_table, coded_table)
    return True


def commit_coll_tables(handle, epoch: int) -> bool:
    """Promote every staged table under the comm lock with the progress
    engine quiesced, stamping ``epoch`` (every rank at the same
    boundary); False when the library predates it."""
    lib = get_lib()
    if not hasattr(lib, "tpucomm_commit_coll_tables"):
        return False
    if lib.tpucomm_commit_coll_tables(int(handle), int(epoch)) != 0:
        raise ValueError(f"bad comm handle {handle}")
    return True


def coll_epoch():
    """The decision table's epoch (0: the table installed at comm
    creation), or None when the library predates live re-tuning."""
    lib = get_lib()
    if not hasattr(lib, "tpucomm_coll_epoch"):
        return None
    return int(lib.tpucomm_coll_epoch())


def _teardown_topology(handle) -> None:
    """Finalize a world handle's topology sub-comms (they borrow its
    sockets, so they go first) and forget its registry entries."""
    from .. import topo

    _topo_subcomms.pop(int(handle), None)
    for sub in _topo_handles.pop(int(handle), []):
        get_lib().tpucomm_finalize(sub)
    topo._forget(handle)


def comm_finalize(handle) -> None:
    """Close a comm: the live hook is disarmed first, then its topology
    sub-comms go."""
    _live_disarm(handle)
    _teardown_topology(handle)
    get_lib().tpucomm_finalize(handle)


def shrink_available() -> bool:
    """True when the loaded library carries the recovery bootstrap."""
    return hasattr(get_lib(), "tpucomm_shrink")


def rebuild(old_handle, new_rank: int, new_size: int, base_port: int,
            hosts: str = "", *, device=None) -> int:
    """Elastic recovery's native step (``elastic.recover`` calls it): tear
    the dead world down and bootstrap a fresh one over the survivors at the
    re-derived ``base_port``; returns the new handle.  Collective over the
    survivors.

    The dead world's topology sub-comms borrow its sockets, and its live
    controller must not rendezvous on it, so both go before
    ``tpucomm_shrink``, which finalizes ``old_handle`` (0 or None when no
    world was connected) and runs the bootstrap of ``tpucomm_init``.  Then
    the per-world setup runs on the new world, discovering its topology
    afresh (a shrink that emptied an island re-derives the map), and last
    the plan layer drops the dead world's runner and re-proves the plan for
    the new size (``planrt.reinstall_after_rebuild``).  ``device`` is the
    world's device, as in ``comm_init``.  If the setup fails (another
    death), the new world is closed again and the error propagates: the
    caller's comm keeps the dead handle, which the next rebuild finalizes
    as a no-op, and no cache holds the new one."""
    lib = get_lib()
    if not hasattr(lib, "tpucomm_shrink"):
        raise RuntimeError(
            "elastic recovery needs a native library with the "
            "tpucomm_shrink bootstrap; rebuild the transport")
    from . import planrt

    if old_handle:
        _teardown_topology(old_handle)
        _live_disarm()
    handle = lib.tpucomm_shrink(int(old_handle or 0), int(new_rank),
                                int(new_size), int(base_port),
                                (hosts or "").encode())
    if handle == 0:
        _abort("shrink", 1)
    try:
        _post_init_setup(lib, handle, new_rank, new_size, device,
                         install_plan=False)
    except BaseException:
        if old_handle:
            planrt.drop(old_handle)
        _close_failed(handle)
        raise
    # the plan layer last, onto a working world; soft like comm_init's
    # install, but never for a rank failure
    try:
        planrt.reinstall_after_rebuild(
            old_handle, handle, new_rank, new_size,
            pin_memory=getattr(device, "type", None) == "cuda")
    except Exception as e:
        from ..elastic import is_rank_failure

        if is_rank_failure(e):
            raise
        import warnings

        warnings.warn(f"schedule-plan reinstall failed after recovery: {e}")
    return handle


def split(handle, color: int, key: int):
    """Collective sub-communicator creation; None when color < 0."""
    h = get_lib().tpucomm_split(handle, int(color), int(key))
    if h == 0:
        _abort("Split", 1)
    return None if h == -1 else h


def dup(handle) -> int:
    """Collective: a comm of the same members with its own message
    space."""
    h = get_lib().tpucomm_dup(handle)
    if h == 0:
        _abort("Dup", 1)
    return h


def shm_active(handle) -> bool:
    """True when the comm's collectives ride the same-host shared-memory
    arena (which wins over every forced algorithm)."""
    slot, ring = ctypes.c_int64(), ctypes.c_int64()
    return get_lib().tpucomm_shm_info(handle, ctypes.byref(slot),
                                      ctypes.byref(ring)) == 1


def set_coll_table(coded_table) -> None:
    """Install the process-wide decision tables: ``{op_kind: [(min_bytes,
    algo_code), ...]}`` (``tune.install``)."""
    _push_tables(get_lib().tpucomm_set_coll_table, coded_table)


def _push_tables(fn, coded_table) -> None:
    """``fn(op_kind, min_bytes[], algo_codes[], n)`` for each op kind's
    table."""
    for op_kind, entries in coded_table.items():
        n = len(entries)
        mins = (ctypes.c_int64 * n)(*[int(e[0]) for e in entries])
        algos = (ctypes.c_int32 * n)(*[int(e[1]) for e in entries])
        fn(int(op_kind), mins, algos, n)


def comm_rank(handle) -> int:
    return get_lib().tpucomm_rank(handle)


def comm_size(handle) -> int:
    return get_lib().tpucomm_size(handle)


def coll_algo_for(handle, op_kind: int, nbytes: int) -> int:
    """The algorithm code the engine would run for (comm, op, bytes)."""
    code = get_lib().tpucomm_coll_algo_for(handle, int(op_kind), int(nbytes))
    if code < 0:
        raise ValueError(f"bad comm handle {handle}")
    return code


# ---------------- ops on contiguous numpy buffers ----------------


def wire_code(a: np.ndarray) -> int:
    """The wire code of a numpy array's dtype (numpy has no bf16: its
    callers pass code 10 with the int16 bits)."""
    return _dtypes.name_code(a.dtype.name)


def _new_out(out, shape, dtype) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype)
    if out.shape != tuple(shape) or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous array of shape "
                         f"{tuple(shape)}, got {out.shape}")
    return out


def send(handle, buf, dest: int, tag: int):
    buf = _contig(buf)
    _check("Send", get_lib().tpucomm_send(handle, _ptr(buf), buf.nbytes,
                                          int(dest), int(tag)))


def recv(handle, out: np.ndarray, source: int, tag: int) -> np.ndarray:
    """Receive into ``out``; the arrived size must equal ``out``'s (the
    transport fails fast otherwise)."""
    _check("Recv", get_lib().tpucomm_recv(handle, _ptr(out), out.nbytes,
                                          int(source), int(tag)))
    return out


def recv_status(handle, out: np.ndarray, source: int, tag: int):
    """Receive into ``out`` (zeroed: a shorter message fills its prefix)
    and return ``(out, source, tag, byte count)`` from the frame header;
    ``tag`` may be ANY_TAG (-1), ``source`` ANY_SOURCE (-2)."""
    out.fill(0)
    src, tg, cnt = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    _check("Recv", get_lib().tpucomm_recv_status(
        handle, _ptr(out), out.nbytes, int(source), int(tag),
        ctypes.byref(src), ctypes.byref(tg), ctypes.byref(cnt)))
    return out, src.value, tg.value, cnt.value


def sendrecv(handle, sendbuf, out: np.ndarray, source: int, dest: int,
             tag: int) -> np.ndarray:
    sendbuf = _contig(sendbuf)
    _check("Sendrecv", get_lib().tpucomm_sendrecv(
        handle, _ptr(sendbuf), sendbuf.nbytes, int(dest), _ptr(out),
        out.nbytes, int(source), int(tag)))
    return out


def sendrecv_status(handle, sendbuf, out: np.ndarray, source: int,
                    dest: int, sendtag: int, recvtag: int):
    """``sendrecv`` with split tags into ``out`` (zeroed), returning
    ``(out, source, tag, byte count)``."""
    sendbuf = _contig(sendbuf)
    out.fill(0)
    src, tg, cnt = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    _check("Sendrecv", get_lib().tpucomm_sendrecv_status(
        handle, _ptr(sendbuf), sendbuf.nbytes, int(dest), _ptr(out),
        out.nbytes, int(source), int(sendtag), int(recvtag),
        ctypes.byref(src), ctypes.byref(tg), ctypes.byref(cnt)))
    return out, src.value, tg.value, cnt.value


def shift2(handle, buf, lo: int, hi: int, tag: int,
           out: np.ndarray) -> np.ndarray:
    """Bidirectional neighbour exchange: ``buf`` is the ``(2, ...)`` stack
    ``[to_lo, to_hi]``; returns ``[from_lo, from_hi]`` (-1 is a wall: the
    opposite input passes through)."""
    buf = _contig(buf)
    out = _new_out(out, buf.shape, buf.dtype)
    _check("Shift2", get_lib().tpucomm_shift2(
        handle, _ptr(buf), _ptr(out), buf.nbytes // 2, int(lo), int(hi),
        int(tag)))
    return out


def barrier(handle):
    if _live_boundary is not None:
        _live_boundary(handle)
    _check("Barrier", get_lib().tpucomm_barrier(handle))


def bcast(handle, buf, root, out=None) -> np.ndarray:
    """The root's ``buf`` on every rank; ``buf`` is not written (the
    broadcast runs in a copy, ``out`` when given)."""
    if _live_boundary is not None:
        _live_boundary(handle)
    buf = _contig(buf)
    out = _new_out(out, buf.shape, buf.dtype)
    np.copyto(out, buf)
    _check("Bcast", get_lib().tpucomm_bcast(handle, _ptr(out), out.nbytes,
                                            int(root)))
    return out


def reduce(handle, buf, op_code: int, root: int, out: np.ndarray,
           dtype_code: int) -> np.ndarray:
    """The reduction on the root; the other ranks get ``buf`` back."""
    if _live_boundary is not None:
        _live_boundary(handle)
    buf = _contig(buf)
    out = _new_out(out, buf.shape, buf.dtype)
    _check("Reduce", get_lib().tpucomm_reduce(
        handle, _ptr(buf), _ptr(out), buf.size, int(dtype_code),
        int(op_code), int(root)))
    return out


def scan(handle, buf, op_code: int, out: np.ndarray,
         dtype_code: int) -> np.ndarray:
    """The inclusive prefix reduction over ranks 0..rank."""
    if _live_boundary is not None:
        _live_boundary(handle)
    buf = _contig(buf)
    out = _new_out(out, buf.shape, buf.dtype)
    _check("Scan", get_lib().tpucomm_scan(
        handle, _ptr(buf), _ptr(out), buf.size, int(dtype_code),
        int(op_code)))
    return out


def gather(handle, buf, size: int, root: int, rank: int, out=None
           ) -> np.ndarray:
    """``(size, *buf.shape)`` on the root; a non-root rank only sends and
    gets ``buf`` back (the reference's contract)."""
    if _live_boundary is not None:
        _live_boundary(handle)
    buf = _contig(buf)
    if rank == root:
        out = _new_out(out, (size,) + buf.shape, buf.dtype)
    else:
        out = buf
    _check("Gather", get_lib().tpucomm_gather(handle, _ptr(buf), buf.nbytes,
                                              _ptr(out), int(root)))
    return out


def scatter(handle, buf, root: int, out: np.ndarray) -> np.ndarray:
    """Row ``rank`` of the root's ``(size, ...)`` buffer."""
    if _live_boundary is not None:
        _live_boundary(handle)
    buf = _contig(buf)
    out = _new_out(out, buf.shape[1:], buf.dtype)
    _check("Scatter", get_lib().tpucomm_scatter(
        handle, _ptr(buf), _ptr(out), out.nbytes, int(root)))
    return out


def allgather_raw(handle, buf: np.ndarray, out: np.ndarray,
                  algo: Optional[int] = None):
    """Allgather of contiguous ``buf`` into ``out``; ``algo`` is the
    algorithm code forced for this call (None or 0: the engine's
    choice)."""
    if _live_boundary is not None:
        _live_boundary(handle)
    _check("Allgather", get_lib().tpucomm_allgather_algo(
        handle, _ptr(buf), buf.nbytes, _ptr(out), int(algo or 0)))


def allgather(handle, buf, size: int) -> np.ndarray:
    buf = _contig(buf)
    out = np.empty((size,) + buf.shape, buf.dtype)
    allgather_raw(handle, buf, out)
    return out


def alltoall(handle, buf, out: np.ndarray, algo: Optional[int],
             dtype_code: int) -> np.ndarray:
    """Row ``j`` of ``buf`` to rank ``j``; row ``j`` of the result from
    rank ``j``.  The typed entry (elements per row and their dtype)."""
    if _live_boundary is not None:
        _live_boundary(handle)
    buf = _contig(buf)
    out = _new_out(out, buf.shape, buf.dtype)
    _check("Alltoall", get_lib().tpucomm_alltoall_algo(
        handle, _ptr(buf), _ptr(out), buf.size // buf.shape[0],
        int(dtype_code), int(algo or 0)))
    return out


def _ici_leg_hook(handle, buf, out, dtype_code, op_code, algo) -> bool:
    """The leg's probe in front of the native allreduce: False in two dict
    lookups on a comm without topology sub-comms or a call that is not
    f32 SUM; the full gate is ``topo._ici_leg.maybe_allreduce``."""
    if int(handle) not in _topo_subcomms:
        return False
    if dtype_code != F32 or op_code != SUM:
        return False
    from ..topo import _ici_leg

    return _ici_leg.maybe_allreduce(handle, buf, out, dtype_code, op_code,
                                    algo)


def allreduce_raw(handle, buf: np.ndarray, out: np.ndarray, dtype_code: int,
                  op_code: int, algo: Optional[int] = None):
    """Allreduce of contiguous ``buf`` into ``out``; ``algo`` is the
    algorithm code forced for this call (None or 0: the engine's choice).
    The intra-island leg (``topo/_ici_leg.py``) takes an eligible call
    before the native paths."""
    if _live_boundary is not None:
        _live_boundary(handle)
    if _ici_leg_hook(handle, buf, out, dtype_code, op_code, algo):
        return
    _check("Allreduce", get_lib().tpucomm_allreduce_algo(
        handle, _ptr(buf), _ptr(out), buf.size, int(dtype_code),
        int(op_code), int(algo or 0)))


def allreduce(handle, buf, op_code: int, algo: Optional[int] = None
              ) -> np.ndarray:
    """The allreduce of ``buf`` into a new array."""
    buf = _contig(buf)
    out = np.empty_like(buf)
    allreduce_raw(handle, buf, out, wire_code(buf), op_code, algo=algo)
    return out


# ---------------- ticketed non-blocking posts (plan execution) ----------
#
# The plan runner (``runtime/planrt.py``) posts descriptors on the progress
# engine without waiting: a hoisted receive reads the wire while the host
# computes, a deferred send streams without blocking the caller.  The
# engine drains FIFO, so post order is wire order, the contract the
# plan's equivalence prover checked.  A post runs the same op body as the
# blocking entries (``engine_run_body``, ``native/tpucomm.cc:6485``), so it
# rides the same-host shm ring whenever the blocking op would.  Every ticket
# is waited exactly once, and the caller keeps the buffers alive until
# then.


class _OpExec(ctypes.Structure):
    """Mirror of ``struct TpuOpExec`` (``native/tpucomm.h:534``), field for
    field."""

    _fields_ = [
        ("kind", ctypes.c_int32),
        ("algo", ctypes.c_int32),
        ("sbuf", ctypes.c_void_p),
        ("rbuf", ctypes.c_void_p),
        ("snbytes", ctypes.c_int64),
        ("rnbytes", ctypes.c_int64),
        ("count", ctypes.c_int64),
        ("dtype", ctypes.c_int32),
        ("rop", ctypes.c_int32),
        ("peer", ctypes.c_int32),
        ("peer2", ctypes.c_int32),
        ("tag", ctypes.c_int32),
        ("tag2", ctypes.c_int32),
    ]


#: the TpuObsOp codes (``native/tpucomm.h``) the posts use as
#: ``TpuOpExec.kind``
_K_SEND, _K_RECV = 0, 1


def post_available() -> bool:
    """True when the loaded library carries the ticketed post entry."""
    return hasattr(get_lib(), "tpucomm_post")


def _post(handle, d: _OpExec) -> int:
    ticket = get_lib().tpucomm_post(int(handle), ctypes.addressof(d))
    if ticket == 0:
        _abort("Post", 1)
    return ticket


def post_send(handle, buf: np.ndarray, dest: int, tag: int):
    """Non-blocking send post; returns ``(ticket, keepalive)``.  The caller
    owns ``buf``'s storage, unchanged, until :func:`wait_ticket` returns
    for the ticket, and holds ``keepalive`` (the contiguous payload and the
    descriptor) until then."""
    buf = _contig(buf)
    d = _OpExec()
    d.kind = _K_SEND
    d.sbuf = _ptr(buf)
    d.snbytes = buf.nbytes
    d.peer = int(dest)
    d.tag = int(tag)
    return _post(handle, d), (buf, d)


def post_recv_into(handle, out: np.ndarray, source: int, tag: int):
    """Non-blocking receive post into ``out``, which stays alive and unread
    until :func:`wait_ticket` returns; returns ``(ticket, keepalive)``."""
    d = _OpExec()
    d.kind = _K_RECV
    d.rbuf = _ptr(out)
    d.rnbytes = out.nbytes
    d.peer2 = int(source)
    d.tag = int(tag)
    return _post(handle, d), d


def post_recv(handle, shape, dtype, source: int, tag: int):
    """Non-blocking receive post into a fresh array; returns ``(ticket,
    out, keepalive)``, ``out`` valid once the ticket is waited."""
    out = np.empty(shape, dtype)
    ticket, d = post_recv_into(handle, out, source, tag)
    return ticket, out, d


def wait_ticket(handle, ticket: int) -> None:
    """Block until a posted op completes; a failed op fails as the blocking
    entries do (exit, or ``RankFailure`` in elastic mode)."""
    _check("WaitTicket", get_lib().tpucomm_wait_ticket(int(handle),
                                                       int(ticket)))


# ---------------- the transport's int8 wire codec ----------------


def quant_packed_bytes(count: int) -> int:
    return int(get_lib().tpucomm_quant_packed_bytes(int(count)))


def quant_pack(buf) -> np.ndarray:
    """The frame of an f32 array through the transport's own codec (the
    bytes its quantized schedules put on the wire)."""
    buf = _contig(buf)
    if buf.dtype != np.float32:
        raise TypeError(f"quant_pack takes float32, got {buf.dtype}")
    out = np.empty(quant_packed_bytes(buf.size), np.int8)
    rc = get_lib().tpucomm_quant_pack(_ptr(buf), buf.size, F32, _ptr(out))
    if rc != 0:
        raise TypeError("the transport refused float32 for its codec")
    return out
