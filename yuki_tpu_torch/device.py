"""Device selection for the PyTorch port.

Every function that allocates takes an explicit ``device``; ``None``
means :func:`default_device`.  Asking for CUDA where there is none
raises instead of running on the CPU: the card path never falls back.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda`` when a card is visible, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None) -> torch.device:
    """Normalise a ``device`` argument; raise if it names CUDA and no card
    is available."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev

