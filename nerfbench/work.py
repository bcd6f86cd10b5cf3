"""The work a step or a frame must do, counted from shapes, and the card's
peaks: the yardstick of the rooflines and the model-FLOP shares.

A step's model FLOPs follow the port's ``session.estimate_flops_per_step``
arithmetic: 3 x 2 x the MLP's multiply-adds a point x rays x (coarse +
merged fine) samples, the multiply-adds counted from the reference's layer
table (for Instant-NGP 17,600 a point: the session's count leaves out one
of the colour MLP's two 64 x 64 hidden layers). A frame's are 2 x multiply-adds x pixels x
samples a ray. The MLP's least time is ``max(ops / peak, bytes /
bandwidth)`` with each input byte read once and each output byte written
once; the encode's is bytes alone (it does no multiply-adds worth
counting). Peaks: ``peaks.json``, the data sheet's dense bf16 rate and HBM
bandwidth by card name.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent


def peaks(card_name: str) -> Optional[Dict[str, float]]:
    """The peaks of the first ``peaks.json`` entry whose key is in
    ``card_name``; None for a card the table does not hold."""
    table = json.loads((HERE / "peaks.json").read_text())
    for key, entry in table.items():
        if key in card_name:
            return entry
    return None


def samples_per_ray(cfg: Dict) -> int:
    """Points a ray: coarse, plus the merged fine set (coarse + fine)."""
    coarse, fine = cfg["renderer.num_samples_coarse"], cfg["renderer.num_samples_fine"]
    return coarse + (coarse + fine if fine > 0 else 0)


def points_per_step(cfg: Dict) -> int:
    return cfg["renderer.num_pixels"] * samples_per_ray(cfg)


def train_flops_per_step(cfg: Dict, ref) -> float:
    return 3.0 * 2.0 * ref.macs_per_point(cfg) * points_per_step(cfg)


def frame_flops(cfg: Dict, ref, pixels: int) -> float:
    return 2.0 * ref.macs_per_point(cfg) * pixels * samples_per_ray(cfg)


def _param_bytes(cfg: Dict, ref) -> int:
    return sum(4 * _prod(shape) for _, shape, kind, _ in ref.layout(cfg) if kind == "linear")


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def mlp_train_least_s(cfg: Dict, ref, pk: Dict[str, float]) -> float:
    """The MLP's forward and backward over a step's points: ops against
    the bf16 peak, bytes (rays, depths and ground truth in; colours, weights
    and gradients out; the f32 weights read once) against the bandwidth."""
    rays = cfg["renderer.num_pixels"]
    points = points_per_step(cfg)
    ops = 3.0 * 2.0 * ref.macs_per_point(cfg) * points
    params = _param_bytes(cfg, ref)
    nbytes = rays * 3 * 4 * 3 + points * 4 * 2 + params + rays * 3 * 4 + points * 4 + params
    return max(ops / pk["flops"], nbytes / pk["bytes_per_s"])


def mlp_forward_least_s(cfg: Dict, ref, points: int, pk: Dict[str, float]) -> float:
    """The MLP's forward over ``points``: positions and directions in,
    density and colour out, the weights read once."""
    ops = 2.0 * ref.macs_per_point(cfg) * points
    nbytes = points * 3 * 4 * 2 + _param_bytes(cfg, ref) + points * 4 * 4
    return max(ops / pk["flops"], nbytes / pk["bytes_per_s"])


def encode_least_s(cfg: Dict, ref, points: int, backward: bool, pk: Dict[str, float]) -> float:
    return ref.encode_bytes(cfg, points, backward) / pk["bytes_per_s"]
