"""Positional (sinusoidal) input encoding.

Counterpart of ``torch_nerf_tpu/encoders.py:48-76``. Spherical-harmonics
encoding comes with the Instant-NGP slice. The fused field kernel
(``ops/fused_nerf.py``) computes the same encoding inside its body.
"""

from __future__ import annotations

import torch


def positional_encoding_dim(in_dim: int, num_levels: int, include_input: bool) -> int:
    """Output width: ``2 * L * d``, plus ``d`` if the raw input is kept."""
    out = 2 * num_levels * in_dim
    if include_input:
        out += in_dim
    return out


def positional_encoding(
    x: torch.Tensor, num_levels: int, include_input: bool = True
) -> torch.Tensor:
    """Official-NeRF encoding (no pi factor), columns
    ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]`` where each
    term spans all ``d`` input channels. ``(..., d) -> (..., D)``."""
    parts = [x] if include_input else []
    for level in range(num_levels):
        freq = float(2**level)
        parts.append(torch.sin(freq * x))
        parts.append(torch.cos(freq * x))
    return torch.cat(parts, dim=-1)
