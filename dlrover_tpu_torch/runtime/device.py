"""Device resolution for the port's entry points.

The port runs on the card.  ``resolve_device(None)`` means ``cuda`` and
raises when no card is present: nothing moves to the CPU unless the caller
asks for ``"cpu"`` (the tests do).  ``"meta"`` is accepted for shape-only
construction (``models.transformer.param_shapes``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev
