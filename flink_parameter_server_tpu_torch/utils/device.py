"""Device selection shared by the port's entry points.

The port runs on the card unless the caller asks for the CPU: every
entry point takes a ``device`` argument whose default is ``"cuda"``.
Asking for ``cuda`` on a machine without a card raises — nothing drops
to the CPU quietly.  The port is single-device for now, so a ``mesh``
argument that is not ``None`` raises as well.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain CPU path"
        )
    return dev


def check_mesh(mesh: Optional[Any]) -> None:
    """Reject a device mesh: multi-device support is ROADMAP Queue 1 #9."""
    if mesh is not None:
        raise NotImplementedError(
            "the torch port is single-device; mesh-sharded stores and "
            "steps are ROADMAP Queue 1 #9 (multi-device)"
        )


__all__ = ["DeviceLike", "resolve_device", "check_mesh"]
