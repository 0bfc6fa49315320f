"""The port's one default device: the card.

Every entry point that takes ``device`` runs on the CUDA device unless the
caller names another one, as the tests do with ``device="cpu"``. Where no
CUDA device is present the default raises: the port never moves work to the
CPU on its own.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``, or ``RuntimeError`` where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present and no device was named: pass "
            'device="cpu" to run the plain PyTorch versions on the host'
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``default_device()``."""
    return default_device() if device is None else torch.device(device)
