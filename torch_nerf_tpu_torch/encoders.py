"""Input encodings: positional (sinusoidal) and spherical harmonics.

Counterpart of ``torch_nerf_tpu/encoders.py``. The fused field kernel
(``ops/fused_nerf.py``) computes the positional encoding inside its body;
the SH encoding of the Instant-NGP field is plain torch, as the JAX package
computes it outside any kernel.
"""

from __future__ import annotations

import torch

# real spherical-harmonics coefficients (the JAX package's tables)
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
_SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


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


def sh_encoding_dim(degree: int) -> int:
    """Output width ``degree ** 2``."""
    return degree * degree


def sh_encoding(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical-harmonics encoding ``(..., 3) -> (..., degree**2)``,
    in the JAX package's component order and signs (the constant DC term,
    degree 1 as ``(-y, z, -x)``). Directions are used as given, not
    normalised, as the reference feeds them."""
    if degree < 1 or degree > 5:
        raise ValueError(f"SH degree must be in [1, 5]. Got {degree}.")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, _SH_C0)]
    if degree > 1:
        comps += [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            _SH_C2[0] * xy,
            _SH_C2[1] * yz,
            _SH_C2[2] * (2.0 * zz - xx - yy),
            _SH_C2[3] * xz,
            _SH_C2[4] * (xx - yy),
        ]
    if degree > 3:
        comps += [
            _SH_C3[0] * y * (3.0 * xx - yy),
            _SH_C3[1] * xy * z,
            _SH_C3[2] * y * (4.0 * zz - xx - yy),
            _SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _SH_C3[4] * x * (4.0 * zz - xx - yy),
            _SH_C3[5] * z * (xx - yy),
            _SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree > 4:
        comps += [
            _SH_C4[0] * xy * (xx - yy),
            _SH_C4[1] * yz * (3.0 * xx - yy),
            _SH_C4[2] * xy * (7.0 * zz - 1.0),
            _SH_C4[3] * yz * (7.0 * zz - 3.0),
            _SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            _SH_C4[5] * xz * (7.0 * zz - 3.0),
            _SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            _SH_C4[7] * xz * (xx - 3.0 * yy),
            _SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)
