"""The intra-island leg of the hierarchical f32 allreduce, on the card.

The counterpart of ``mpi4jax_tpu/topo/_ici_leg.py`` (``:201-327``).  On a
multi-island world, an f32 SUM allreduce forced to ``hring`` or ``htree``
(or picked so by the engine) runs in three phases, when plan execution
is off (``MPI4JAX_TPU_PLAN``) and ``MPI4JAX_TPU_ICI_LEG`` is ``force``,
or ``auto`` with every member of every multi-member island backed by a
card (tier ``"ici"``, ``topo/__init__.py``):

1. intra: the island members' rows are allgathered over the intra-island
   comm and folded by the fused ring, kernel 3
   (``_collectives.fused_ring_kernel``), on the comm's device: bit for bit
   ``simulate_ring_sum``.  Under ``MPI4JAX_TPU_COLL_QUANT=force`` every
   rank then packs the island sum into the transport's int8 wire frame
   with kernel 4 (``quantized.quant_pack``);
2. leaders: exact mode runs the flat twin (``ring`` for ``hring``, ``rd``
   for ``htree``) over the leaders' comm; quantized mode allgathers the
   frames and every leader dequantizes and folds them in island order in
   f32 (``simulate_ici_q_sum`` is the model);
3. the leader's bytes are broadcast over the island.

On a CUDA device a failed build or launch of kernel 3 or 4 raises: the
plain versions run only when the comm's device is the CPU, or inside
``_collectives.use_plain()`` (the oracle a kernel run is held to).  When the
recorder is armed, each call records one ``Allreduce`` span over phase 1
(the intra leg and the pack) with ``algo=`` the hierarchical schedule and
``tier="ici"``, as the JAX leg's ``_record_leg`` (``:238-246`` there):
stats count its bytes under ``tier_bytes`` and the tuner ignores it.
``PHASE_SECONDS`` sums the
host-clock seconds of each phase over the calls since it was last reset:
the device phases end with a synchronize, so they hold their kernels.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops import _collectives, quantized
from ..utils import algos, config

#: native wire codes (native/tpucomm.h): the leg is f32 SUM only
_F32, _SUM = 11, 0

PHASES = ("intra_allgather", "fold", "pack", "leader_exchange",
          "unpack_fold", "bcast")
PHASE_SECONDS = dict.fromkeys(PHASES, 0.0)


def reset_phases() -> None:
    for k in PHASE_SECONDS:
        PHASE_SECONDS[k] = 0.0


def _island_ring_sum(rows: np.ndarray, device) -> torch.Tensor:
    """(m, count) f32 member rows -> the island sum on ``device``: one
    launch of kernel 3 on a CUDA device, its plain version on the CPU and
    inside ``_collectives.use_plain()``; both are ``simulate_ring_sum``'s
    association."""
    t = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)
    if _collectives.on_kernel(t):
        return _collectives.fused_ring_kernel(t)[0]
    return _collectives.fused_ring_allreduce_plain(t)[0]


def _pack(island: torch.Tensor) -> np.ndarray:
    """The int8 wire frame of the island sum (scale bytes, then codes):
    kernel 4 on a CUDA tensor, ``quant_pack_plain`` on a CPU one."""
    return quantized.quant_pack(island).cpu().numpy()


def _unpack_fold(frames: np.ndarray, order, count: int) -> np.ndarray:
    """Dequantize the leaders' frames and fold them in island order, f32
    throughout (no re-quantization)."""
    nb = -(-count // quantized.QUANT_BLOCK)
    acc = None
    for row in order:
        frame = frames[row]
        scales = frame[:4 * nb].copy().view(np.float32)
        d = quantized.quant_unpack_ref(scales, frame[4 * nb:])
        acc = d if acc is None else (acc + d).astype(np.float32)
    return acc


def _record_leg(algo_name: str, t0: float, dur: float, nbytes: int) -> None:
    from ..obs import _recorder

    if _recorder.enabled():
        _recorder.record_span("Allreduce", t0, dur, nbytes=nbytes,
                              algo=algo_name, tier="ici")


def eligible(t, *, mode: Optional[str] = None) -> bool:
    """Topology-level eligibility: multi-island, hierarchy not denied, plan
    execution off and, under ``auto``, every multi-member island wholly on
    cards.  A plan's proof covers the world ops its analyzer saw, and the
    leg's sub-comm traffic is not among them, so a planned job keeps the
    native schedules."""
    mode = mode or config.ici_leg_mode()
    if mode == "off" or t is None or not t.multi:
        return False
    if config.hier_mode() == "deny":
        return False
    if config.plan_spec() is not None:
        return False
    if mode == "force":
        return True
    return all(all(t.tiers[r] == "ici" for r in members)
               for members in t.islands if len(members) > 1)


def ici_leg_status(handle=None) -> dict:
    """``{"mode", "backend", "active"}``: ``active`` is the topology-level
    eligibility of ``handle`` (False without one); ``backend`` is the
    device the leg's kernels run on (``"cpu"`` means the plain versions)."""
    from . import get_topology
    from ..runtime import bridge

    mode = config.ici_leg_mode()
    t = get_topology(handle) if handle is not None else None
    sub = bridge._topo_subcomms.get(int(handle)) if handle is not None \
        else None
    return {
        "mode": mode,
        "backend": str(sub["device"]) if sub else None,
        "active": bool(t is not None and eligible(t, mode=mode)),
    }


def maybe_allreduce(handle, buf, out, dtype_code: int, op_code: int,
                    algo) -> bool:
    """Run the leg for this ``allreduce_raw`` call if it is eligible;
    True when ``out`` holds the result, False to fall through to the
    native paths.  Every gate is a function of state the ranks agree on
    (the knobs, the shared topology, the forced code)."""
    mode = config.ici_leg_mode()
    if mode == "off":
        return False
    if dtype_code != _F32 or op_code != _SUM:
        return False
    from ..runtime import bridge

    sub = bridge._topo_subcomms.get(int(handle))
    if sub is None:
        return False
    t = sub["topology"]
    if not eligible(t, mode=mode):
        return False
    code = int(algo or 0)
    if not code:
        code = bridge.coll_algo_for(handle, 0, buf.nbytes)
    if code == algos.ALGO_CODES["hring"]:
        algo_name, leader_algo = "hring", algos.ALGO_CODES["ring"]
    elif code == algos.ALGO_CODES["htree"]:
        algo_name, leader_algo = "htree", algos.ALGO_CODES["rd"]
    else:
        return False
    if buf.dtype != np.float32:
        return False

    dev = sub["device"]
    members = t.islands[sub["island"]]
    m = len(members)
    count = buf.size
    quant = config.quant_mode() == "force"
    clock = time.perf_counter

    # ---- phase 1: the intra leg on the card ------------------------
    t0_unix = time.time()
    t0 = clock()
    if m > 1:
        rows = bridge.allgather(sub["intra"], buf.reshape(-1), m)
        t1 = clock()
        island = _island_ring_sum(rows, dev)
    else:
        t1 = t0
        island = torch.from_numpy(
            np.array(buf, np.float32).reshape(-1)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the fold's phase holds kernel 3
    t2 = clock()
    packed = _pack(island) if quant else None
    island_host = None if quant else island.cpu().numpy()
    t3 = clock()
    _record_leg(algo_name, t0_unix, t3 - t0, buf.nbytes)
    PHASE_SECONDS["intra_allgather"] += t1 - t0
    PHASE_SECONDS["fold"] += t2 - t1
    PHASE_SECONDS["pack"] += t3 - t2

    # ---- phase 2: the leader leg -----------------------------------
    L = t.n_islands
    # leader-comm rank r is the r-th smallest leader world rank; the fold
    # runs in island order
    leader_order = sorted(range(L), key=lambda i: t.leaders[i])
    res = None
    if sub["leader"] is not None:
        if quant:
            frames = bridge.allgather(sub["leader"], packed, L)
            t4 = clock()
            by_island = {isl: r for r, isl in enumerate(leader_order)}
            res = _unpack_fold(frames, [by_island[i] for i in range(L)],
                               count)
            PHASE_SECONDS["unpack_fold"] += clock() - t4
        else:
            res = bridge.allreduce(sub["leader"], island_host, _SUM,
                                   algo=leader_algo)
            t4 = clock()
        PHASE_SECONDS["leader_exchange"] += t4 - t3

    # ---- phase 3: the leader's bytes over the island ---------------
    t5 = clock()
    if m > 1:
        root = members.index(t.leaders[sub["island"]])
        if res is None:
            res = np.empty(count, np.float32)  # the root's bytes arrive
        res = bridge.bcast(sub["intra"], res, root)
    np.copyto(out, np.asarray(res, np.float32).reshape(out.shape))
    PHASE_SECONDS["bcast"] += clock() - t5
    return True
