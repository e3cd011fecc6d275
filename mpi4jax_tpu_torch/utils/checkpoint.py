"""Checkpoint and resume for trees of tensors.

The counterpart of ``mpi4jax_tpu/utils/checkpoint.py``, file for file: a
checkpoint written by either package restores in the other.

- :func:`save` / :func:`restore`: one tree, one ``.npz`` file, written
  atomically (the payload lands in ``<path>.tmp.<pid>`` and is
  ``os.replace``d into place, so a crash mid-save leaves the previous file
  as it was).  The port always writes ``.npz``, as the JAX package does
  without orbax.
- :func:`save_sharded` / :func:`restore_sharded`: one directory per step
  holding one shard per rank and a ``manifest.json`` written last, between
  two barriers of the world comm.  A checkpoint exists iff its manifest
  does: a kill at any point of the save leaves the previous committed step
  and a manifest-less directory that :func:`latest_step` ignores.

Every leaf is stored as its raw bytes (``leaf_<i>``, uint8) with its dtype
name and shape in a JSON descriptor, the JAX package's format 2.  The
dtype names are numpy's (``float32``, ``bfloat16``, ...), mapped to torch
dtypes here, so bf16 needs no ``ml_dtypes``: the bytes move through
``tensor.view(torch.uint8)``.  Leaves are flattened in ``jax.tree``'s
order (``utils/tree.py``: sorted dict keys, ``None`` an empty node).
Format-1 files (plain ``leaf_<i>`` arrays, no descriptor) still read.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from . import config
from .tree import flatten, unflatten

MANIFEST = "manifest.json"
_META_KEY = "__m4j_meta__"
_FORMAT = 2

#: dtype names of the JAX package's descriptors (numpy's) -> torch dtypes
DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (numpy arrays and Python scalars
    go through numpy, as the JAX package's ``np.asarray`` does)."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)))
    return leaf.detach().cpu().contiguous()


def _leaf_bytes(t: torch.Tensor) -> np.ndarray:
    if t.dtype not in _NAMES:
        raise TypeError(f"checkpoint leaf dtype {t.dtype} has no name in "
                        "the JAX package's format")
    return t.reshape(-1).view(torch.uint8).numpy()


# ---------------- leaf codec + atomic npz ----------------


def _write_npz(path: str, tree: Any, extra_meta: Optional[dict] = None
               ) -> None:
    """Atomically write one tree as an npz archive: every leaf as raw bytes
    plus a JSON descriptor naming its dtype and shape."""
    leaves, _ = flatten(tree)
    arrays = {}
    metas = []
    for i, leaf in enumerate(leaves):
        t = _as_tensor(leaf)
        arrays[f"leaf_{i}"] = _leaf_bytes(t)
        metas.append({"dtype": _NAMES[t.dtype], "shape": list(t.shape)})
    meta = {"format": _FORMAT, "nleaves": len(leaves), "leaves": metas}
    meta.update(extra_meta or {})
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), np.uint8).copy()
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _resolve_dtype(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise TypeError(f"checkpoint leaf dtype {name!r} has no torch "
                        "dtype") from None


def _read_npz(path: str):
    """``(leaves, meta)``: CPU tensors in the stored dtypes; also reads
    format-1 files (native dtypes, no descriptor)."""
    data = np.load(path)
    if _META_KEY not in data.files:
        n = len([k for k in data.files if k.startswith("leaf_")])
        return ([torch.from_numpy(np.array(data[f"leaf_{i}"]))
                 for i in range(n)], {"format": 1, "nleaves": n})
    meta = json.loads(bytes(data[_META_KEY].tobytes()).decode())
    leaves = []
    for i, desc in enumerate(meta["leaves"]):
        dtype = _resolve_dtype(desc["dtype"])
        raw = torch.from_numpy(np.array(data[f"leaf_{i}"], np.uint8))
        if raw.numel() == 0:  # an empty uint8 view cannot change its width
            leaves.append(torch.empty(desc["shape"], dtype=dtype))
        else:
            leaves.append(raw.view(dtype).reshape(desc["shape"]))
    return leaves, meta


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _check_match(path: str, like_leaves, loaded_leaves) -> None:
    """Loud, specific mismatch errors: a silent zip would truncate."""
    if len(like_leaves) != len(loaded_leaves):
        raise ValueError(
            f"checkpoint {path} holds {len(loaded_leaves)} leaves but "
            f"the provided tree has {len(like_leaves)} — the model "
            "architecture (or optimizer state shape) changed since the "
            "checkpoint was written")
    for i, (want, got) in enumerate(zip(like_leaves, loaded_leaves)):
        if _shape(want) != tuple(got.shape):
            raise ValueError(
                f"checkpoint {path} leaf {i} has shape "
                f"{tuple(got.shape)} but the provided tree expects "
                f"{_shape(want)}")


def _placed(like_leaves, loaded_leaves):
    """Each loaded leaf on the device and in the dtype of its counterpart
    in ``like`` when that is a tensor; a CPU tensor as stored otherwise."""
    return [got.to(device=want.device, dtype=want.dtype)
            if isinstance(want, torch.Tensor) else got
            for want, got in zip(like_leaves, loaded_leaves)]


def _restore_from(path: str, like: Any):
    leaves, meta = _read_npz(path)
    like_leaves, treedef = flatten(like)
    _check_match(path, like_leaves, leaves)
    return unflatten(treedef, _placed(like_leaves, leaves)), meta


# ---------------- single-file API ----------------


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tree: Any) -> None:
    """Save a tree of tensors to ``path`` (``.npz`` appended when missing),
    atomically: a crash mid-save leaves a previous file untouched."""
    _write_npz(_npz(path), tree)


def restore(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save` (by either package); ``like``
    gives the structure, and the device and dtype of each tensor leaf.
    Raises ``ValueError`` naming the mismatch when ``like`` does not match
    what the checkpoint holds."""
    return _restore_from(_npz(path), like)[0]


# ---------------- sharded, committed, generation-stamped ----------------


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{int(step):08d}")


def _shard_path(d: str, rank: int, nshards: int) -> str:
    return os.path.join(d, f"shard{int(rank)}of{int(nshards)}.npz")


def committed_steps(directory: str):
    """Steps with a committed manifest, ascending.  Manifest-less step
    directories (an interrupted save) are invisible here by design."""
    steps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return steps
    for name in names:
        if not name.startswith("step_"):
            continue
        if not os.path.exists(os.path.join(directory, name, MANIFEST)):
            continue
        try:
            steps.append(int(name[len("step_"):]))
        except ValueError:
            continue
    return sorted(steps)


def latest_step(directory: str):
    """The newest committed step in ``directory``, or None."""
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _resolve_dir(directory):
    directory = directory or config.ckpt_dir()
    if not directory:
        raise ValueError(
            "no checkpoint directory: pass directory= or set "
            "MPI4JAX_TPU_CKPT_DIR")
    return directory


def _comm_coords(comm):
    if comm is None:
        return 0, 1
    return int(comm.rank()), int(comm.size())


def _barrier(comm) -> None:
    if comm is None or comm.size() <= 1:
        return
    from ..runtime import bridge

    bridge.barrier(comm.handle)


def save_sharded(tree: Any, *, step: int, directory: Optional[str] = None,
                 comm=None, generation: Optional[int] = None,
                 replicated: bool = True, keep: Optional[int] = None,
                 _crash_point: Optional[str] = None) -> str:
    """Write one committed checkpoint for ``step``; returns its directory.
    Collective over ``comm``, a world comm (None: a single process).

    Every rank writes its shard atomically into the step directory, a
    barrier confirms every shard is on disk, then rank 0 atomically writes
    ``manifest.json`` (the commit point) and a second barrier releases the
    others.  ``replicated`` records that every rank's tree is the same (the
    DP pattern), so the checkpoint restores onto another world size.
    ``generation`` is the world generation stamped into the manifest
    (default: the live one, ``elastic.current_generation()``, as the JAX
    package's).  ``keep`` prunes all but the newest ``keep`` committed
    steps after the commit.

    ``_crash_point`` is a test seam: ``"after_shard"`` dies before the
    manifest exists, ``"mid_commit"`` after its tmp file is written but
    before the rename.
    """
    directory = _resolve_dir(directory)
    rank, nshards = _comm_coords(comm)
    if generation is None:
        from ..elastic import current_generation

        generation = current_generation()
    d = step_dir(directory, step)
    os.makedirs(d, exist_ok=True)
    _write_npz(_shard_path(d, rank, nshards), tree,
               {"step": int(step), "rank": rank, "nshards": nshards,
                "generation": int(generation)})
    if _crash_point == "after_shard":
        os._exit(137)
    _barrier(comm)
    if rank == 0:
        manifest = {
            "version": 1,
            "step": int(step),
            "generation": int(generation),
            "nshards": nshards,
            "replicated": bool(replicated),
            "shards": [os.path.basename(_shard_path(d, r, nshards))
                       for r in range(nshards)],
        }
        tmp = os.path.join(d, f"{MANIFEST}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if _crash_point == "mid_commit":
            os._exit(137)
        os.replace(tmp, os.path.join(d, MANIFEST))
    _barrier(comm)
    if keep is not None and rank == 0:
        for old in committed_steps(directory)[:-max(int(keep), 1)]:
            shutil.rmtree(step_dir(directory, old), ignore_errors=True)
    return d


def restore_sharded(like: Any, *, directory: Optional[str] = None,
                    step: Optional[int] = None, comm=None):
    """Restore the newest committed checkpoint (or ``step``); returns
    ``(tree, step, manifest)``.  Raises ``FileNotFoundError`` when no
    committed checkpoint exists.

    A rank reads its own shard when the world size matches the
    checkpoint's; on another size only a ``replicated`` checkpoint is
    accepted, rank r reading shard ``min(r, nshards - 1)``.
    """
    directory = _resolve_dir(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {directory} (a directory "
                "without manifest.json is an interrupted save)")
    d = step_dir(directory, step)
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    nshards = int(manifest["nshards"])
    rank, size = _comm_coords(comm)
    if size == nshards:
        shard = rank
    elif manifest.get("replicated", False):
        shard = min(rank, nshards - 1)
    else:
        raise ValueError(
            f"checkpoint {d} holds {nshards} non-replicated shards but "
            f"the world now has {size} ranks — resharding is not "
            "supported; save replicated=True state (the DP pattern) to "
            "survive world-size changes")
    tree, _ = _restore_from(_shard_path(d, shard, nshards), like)
    return tree, int(step), manifest
