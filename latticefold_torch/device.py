"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. With
no card and no explicit CPU request they raise: nothing silently falls back
to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def constant(arr, device: torch.device) -> torch.Tensor:
    """A host array of u32 limbs (or small ints) as an int64 tensor on
    ``device``. On the card the copy is made from pinned memory without
    waiting for it (torch's caching host allocator keeps the buffer until
    the copy is done), so the device-transcript provers can make their
    constants inside a run that must not synchronize with the host."""
    t = torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def resolve(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when CUDA is requested but
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "latticefold_torch: no CUDA device available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev
