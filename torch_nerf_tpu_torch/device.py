"""Device selection: the card by default, the CPU only when asked for.

An entry point that finds no CUDA device when it was not told to use the CPU
raises; it never carries on silently on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(name: Optional[str] = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> the card (raises if absent);
    ``"cpu"`` -> the CPU."""
    device = torch.device("cuda" if name is None else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{device}' requested but CUDA is not available; "
            "pass --device cpu (or device='cpu') to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device '{name}'.")
    return device
