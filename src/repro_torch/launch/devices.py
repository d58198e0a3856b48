"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA device.  Raises
    when CUDA is asked for and absent: the entry points never move to the
    CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    return dev
