"""Shared hash-grid math: level resolutions, corner order, spatial hash.

Counterpart of ``torch_nerf_tpu/models/hash_math.py`` (the port keeps its
own copy). The Teschner-prime XOR hash runs in int64 masked to 32 bits:
int64 products wrap mod 2^64, which keeps the low 32 bits of the uint32
wraparound product right. The 32-bit result is reinterpreted as int32
before a ``torch.remainder``, which gives ``jnp.mod``'s non-negative value
(``hash_math.py:51-64`` of the JAX package). The voxel-packed ``packed_prep``
comes with the packed-layout slice.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128

# Teschner et al. 2003 spatial-hash primes
HASH_PRIMES = (1, 2654435761, 805459861)

# (8, 3) corner selector: 0 -> floor, 1 -> ceil; the reference's order
# fff, cff, fcf, ffc, ccf, cfc, fcc, ccc
CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 1, 0],
        [1, 0, 1],
        [0, 1, 1],
        [1, 1, 1],
    ],
    dtype=np.float32,
)

MASK32 = 0xFFFFFFFF


def level_resolutions(num_level: int, min_res: int, max_res: int) -> np.ndarray:
    """Geometric progression floor(min * b^l), b = (max/min)^(1/(L-1))."""
    if num_level == 1:
        return np.asarray([float(min_res)], dtype=np.float32)
    coeff = (max_res / min_res) ** (1.0 / (num_level - 1))
    return np.floor(min_res * coeff ** np.arange(num_level)).astype(np.float32)


def lattice_u32(v: torch.Tensor) -> torch.Tensor:
    """Integral float lattice coordinates -> their int32 bits as uint32
    values in int64 (``v.astype(int32).astype(uint32)``)."""
    return v.to(torch.int32).to(torch.int64) & MASK32


def hash_axis(h: torch.Tensor, v_u32: torch.Tensor, axis: int) -> torch.Tensor:
    """``h ^ (v * prime[axis])`` in uint32 wraparound, held in int64."""
    return h ^ ((v_u32 * HASH_PRIMES[axis]) & MASK32)


def as_int32(h: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 they reinterpret as."""
    return torch.where(h >= 2**31, h - 2**32, h)


def spatial_hash(vert_coords: torch.Tensor, num_entries: int) -> torch.Tensor:
    """XOR of prime-multiplied int32 coords, mod table size -> (...,) int64.

    ``vert_coords``: (..., 3) integers. The multiply wraps in 32 bits; the
    modulo of the int32-reinterpreted hash is non-negative.
    """
    v = lattice_u32(vert_coords)
    h = torch.zeros_like(v[..., 0])
    for axis in range(3):
        h = hash_axis(h, v[..., axis], axis)
    return torch.remainder(as_int32(h), num_entries)
