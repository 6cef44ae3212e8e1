"""Device selection for the PyTorch port.

Every function that allocates takes an explicit ``device``; ``None``
means :func:`default_device`, the card.  Where no card is visible that
raises: the port runs on the CPU only when the caller asks for it with
``device="cpu"``, never as a quiet fallback.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda``: the port's entry points run on the card."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """Normalise a ``device`` argument (None: :func:`default_device`);
    raise if it names CUDA and no card is available."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False;"
            " pass device=\"cpu\" to run on the CPU"
        )
    return dev
