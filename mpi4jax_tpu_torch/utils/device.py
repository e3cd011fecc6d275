"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch

MULTI_DEVICE = (
    "ranks on more than one device are not ported yet: every rank of a mesh "
    "lives on one card (ROADMAP.md, slice A: multi-GPU placement of ranks)"
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``cuda:0``.  A CUDA device without CUDA raises: the port
    never moves to the CPU quietly, the caller asks for it with
    ``device="cpu"``.  A list or tuple of devices names the devices of a
    mesh; more than one distinct device raises ``NotImplementedError``.
    """
    if isinstance(device, (list, tuple)):
        devs = {torch.device(d) for d in device}
        devs = {torch.device(d.type, d.index or 0) if d.type == "cuda" else d
                for d in devs}
        if len(devs) > 1:
            raise NotImplementedError(MULTI_DEVICE)
        if not devs:
            raise ValueError("an empty list of devices")
        device = devs.pop()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
