"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``. With
no card and no explicit CPU request they raise: nothing silently falls back
to the host.
"""

from __future__ import annotations

import torch


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
