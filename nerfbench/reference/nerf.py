"""NeRF (Mildenhall et al., ECCV 2020, arXiv:2003.08934, section 5.3 and
appendix A): positional encoding and the 8-layer, 256-wide MLP with its
skip, in plain PyTorch.

The layer table is a frozen copy of the network the paper draws (eleven
linear layers): ``fc_in`` and ``fc_1``-``fc_4`` on the encoded position,
the skip concatenating ``[position encoding, h]`` into ``fc_5``,
``fc_6``-``fc_7``, ``fc_8`` giving the density in its first column and a
feature vector in the rest, ``fc_9`` on ``[features, direction encoding]``
at half width, and ``fc_out`` to RGB. Weights are stored ``(in, out)``.
The encoding is ``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x),
cos(2^(L-1) x)]``, each term over the three channels, without a factor of
pi (the published code's form). Density ``relu``, colour ``sigmoid``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from nerfbench.reference.lowp import Rounding, linear


def encoding_dim(levels: int, include_input: bool, dim: int = 3) -> int:
    return 2 * levels * dim + (dim if include_input else 0)


def layer_table(cfg: Dict) -> Dict[str, Tuple[int, int]]:
    """(in, out) of each linear layer."""
    f = cfg["network.feat_dim"]
    p = encoding_dim(cfg["signal_encoder.coord_encode_level"], cfg["signal_encoder.include_input"])
    d = encoding_dim(cfg["signal_encoder.dir_encode_level"], cfg["signal_encoder.include_input"])
    table = {"fc_in": (p, f)}
    for i in range(1, 5):
        table[f"fc_{i}"] = (f, f)
    table["fc_5"] = (f + p, f)
    table["fc_6"] = (f, f)
    table["fc_7"] = (f, f)
    table["fc_8"] = (f, f + 1)
    table["fc_9"] = (f + d, f // 2)
    table["fc_out"] = (f // 2, 3)
    return table


def networks(cfg: Dict) -> List[str]:
    return ["coarse", "fine"] if cfg["renderer.num_samples_fine"] > 0 else ["coarse"]


def layout(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str, int]]:
    """Every leaf: ``(path, shape, kind, fan_in)``, kind ``linear``."""
    leaves = []
    for net in networks(cfg):
        for name, (i, o) in layer_table(cfg).items():
            leaves.append(((net, name, "w"), (i, o), "linear", i))
            leaves.append(((net, name, "b"), (o,), "linear", i))
    return leaves


def macs_per_point(cfg: Dict) -> int:
    return sum(i * o for i, o in layer_table(cfg).values())


POSITION_LEVEL_DECAY = 0.25  # rows reading position level l scaled by this ** l
DENSITY_BIAS = 0.5  # added to the density's pre-activation


def prepare(params: Dict, cfg: Dict) -> None:
    """Shape seeded weights, in place in every network, into a field like
    a trained one: the rows of ``fc_in`` and ``fc_5`` that read the
    position encoding's level ``l`` scaled by ``POSITION_LEVEL_DECAY ** l``
    (low frequencies dominate, so a change of precision rarely moves a
    fine sample by a whole bin), and ``DENSITY_BIAS`` added to the
    density's pre-activation (``fc_8``'s first bias; a density positive
    almost everywhere, not cut to 0 by the relu on some seeds)."""
    inc = cfg["signal_encoder.include_input"]
    scale = [1.0] * (3 if inc else 0)
    for level in range(cfg["signal_encoder.coord_encode_level"]):
        scale += [POSITION_LEVEL_DECAY**level] * 6
    for net in params.values():
        col = torch.tensor(scale, dtype=net["fc_in"]["w"].dtype, device=net["fc_in"]["w"].device)[:, None]
        net["fc_in"]["w"].mul_(col)
        net["fc_5"]["w"][: len(scale)].mul_(col)
        net["fc_8"]["b"][0] += DENSITY_BIAS


def positional_encoding(x: torch.Tensor, levels: int, include_input: bool) -> torch.Tensor:
    parts = [x] if include_input else []
    for level in range(levels):
        parts += [torch.sin((2.0**level) * x), torch.cos((2.0**level) * x)]
    return torch.cat(parts, dim=-1)


def field(params: Dict, pts: torch.Tensor, dirs: torch.Tensor, cfg: Dict, rounding: Rounding = None):
    """``(sigma (...), rgb (..., 3))`` of one network at points and
    (unnormalised) ray directions."""
    inc = cfg["signal_encoder.include_input"]
    pe = positional_encoding(pts, cfg["signal_encoder.coord_encode_level"], inc)
    de = positional_encoding(dirs, cfg["signal_encoder.dir_encode_level"], inc)

    def lin(name, x):
        return linear(x, params[name]["w"], params[name]["b"], rounding)

    h = pe
    for name in ("fc_in", "fc_1", "fc_2", "fc_3", "fc_4"):
        h = torch.relu(lin(name, h))
    h = torch.cat([pe, h], dim=-1)
    for name in ("fc_5", "fc_6", "fc_7"):
        h = torch.relu(lin(name, h))
    z = lin("fc_8", h)
    sigma = torch.relu(z[..., 0])
    h = torch.relu(lin("fc_9", torch.cat([z[..., 1:], de], dim=-1)))
    rgb = torch.sigmoid(lin("fc_out", h))
    return sigma, rgb
