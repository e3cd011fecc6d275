"""The discovery handshake: allgather the ranks' host fingerprints over a
fresh world comm (a length row, then the JSON blobs padded to one width)
and build the Topology.  A copy of ``mpi4jax_tpu/topo/_discover.py``."""

from __future__ import annotations

import json

import numpy as np

from . import FINGERPRINT_VERSION, Topology, local_fingerprint


def discover(handle, rank: int, size: int, device=None) -> Topology:
    from ..runtime import bridge

    fp = local_fingerprint(rank, size, device)
    blob = json.dumps(fp, sort_keys=True).encode()
    lens = bridge.allgather(
        handle, np.array([len(blob)], np.int64), size).ravel()
    width = int(lens.max())
    mine = np.zeros(width, np.uint8)
    mine[: len(blob)] = np.frombuffer(blob, np.uint8)
    rows = bridge.allgather(handle, mine, size)
    fingerprints = []
    for r in range(size):
        raw = bytes(rows[r][: int(lens[r])])
        try:
            parsed = json.loads(raw.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise RuntimeError(
                f"topology discovery: rank {r}'s fingerprint is "
                f"unparseable ({e}); mixed framework versions?") from e
        if int(parsed.get("v", -1)) != FINGERPRINT_VERSION:
            raise RuntimeError(
                f"topology discovery: rank {r} speaks fingerprint "
                f"version {parsed.get('v')!r}, this rank "
                f"{FINGERPRINT_VERSION}: mixed framework versions")
        fingerprints.append(parsed)
    return Topology(fingerprints)
