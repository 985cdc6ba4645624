"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` is the
    default everywhere; without a visible card it raises rather than
    quietly running the plain PyTorch path on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to PyTorch; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the host")
    return dev
