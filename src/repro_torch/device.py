"""Device selection for the PyTorch port.

Every entry point takes a ``device`` argument.  ``None`` means the CUDA
card; the CPU runs only when a caller asks for it (``device="cpu"``, as the
tests do).  The choice is resolved on every call and never at import, so a
process that imports the package before it can see a card, or that moves
work between devices, always routes by the device it was handed.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device a call runs on; raises if a CUDA card is missing.

    ``None`` resolves to ``cuda``.  There is no silent CPU fallback: a
    caller that wants the host passes ``"cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host")
    return dev
