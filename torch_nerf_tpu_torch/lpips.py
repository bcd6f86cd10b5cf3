"""LPIPS (Learned Perceptual Image Patch Similarity), AlexNet variant.

Counterpart of ``torch_nerf_tpu/lpips.py``: AlexNet's five convolutions
(``torch.nn.functional.conv2d``, relu taps relu1..relu5, max-pool 3/2 after
the first two), each tap unit-normalised over its channels, the squared
difference weighted by the calibrated ``lin`` vector, its spatial mean, and
the sum over the taps: Zhang et al. 2018's ``lpips(net='alex')`` forward,
computed in float32 (TF32 off, so the card agrees with the CPU).

The weights are data: the repository holds none and downloads none.
:func:`load_weights` looks, in order, at

1. ``$LPIPS_WEIGHTS``: a ``.npz`` in :func:`export_weights_npz`'s format
   (``conv{i}_w``, ``conv{i}_b``, ``lin{i}``, the JAX package's), or a
   directory holding the files below;
2. ``~/.cache/torch/hub/checkpoints/`` and ``~/.cache/torch_nerf_tpu/``:
   any ``.npz`` of that format, or torchvision's ``alexnet-owt-7be5be79.pth``
   backbone plus an LPIPS ``lin`` state dict (``alex.pth`` of
   PerceptualSimilarity, or a torchmetrics / lpips-package one with
   ``lin*`` keys), read with ``torch.load(weights_only=True)``,

and gives None when none is found: callers then report the metric as
unavailable; there is no uncalibrated fallback.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# torchvision AlexNet ``features``: (out_ch, kernel, stride, pad) of the
# five convs; max-pool(3, 2) after conv1 and conv2
CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)
# the input scaling of Zhang et al.'s ScalingLayer, on [-1, 1] images
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSWeights:
    """The backbone's conv kernels and biases and the calibrated lin
    weights, numpy float32."""

    def __init__(self, convs: Sequence[Tuple[np.ndarray, np.ndarray]], lins: Sequence[np.ndarray]):
        if len(convs) != 5 or len(lins) != 5:
            raise ValueError("LPIPS-alex needs 5 conv layers and 5 lin weights")
        self.convs = list(convs)  # [(Oc, Ic, k, k), (Oc,)] per layer
        self.lins = list(lins)  # (C,) per tap


def export_weights_npz(weights: LPIPSWeights, path: str | Path) -> None:
    """Bundle the backbone and lin weights into one ``.npz``."""
    arrs = {}
    for i, (w, b) in enumerate(weights.convs):
        arrs[f"conv{i}_w"] = w
        arrs[f"conv{i}_b"] = b
    for i, lin in enumerate(weights.lins):
        arrs[f"lin{i}"] = lin
    np.savez(path, **arrs)


def _load_npz(path: Path) -> Optional[LPIPSWeights]:
    try:
        with np.load(path) as data:
            convs = [(data[f"conv{i}_w"].astype(np.float32), data[f"conv{i}_b"].astype(np.float32))
                     for i in range(5)]
            lins = [data[f"lin{i}"].astype(np.float32).reshape(-1) for i in range(5)]
    except (OSError, KeyError, ValueError):
        return None
    return LPIPSWeights(convs, lins)


def _load_torch_state(path: Path) -> Optional[Dict[str, np.ndarray]]:
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, RuntimeError, ValueError, EOFError):
        return None
    if not isinstance(state, dict):
        return None
    return {k: v.detach().float().numpy() for k, v in state.items() if isinstance(v, torch.Tensor)}


def _extract_backbone(state: Dict[str, np.ndarray]) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
    convs = []
    for i, layer in enumerate((0, 3, 6, 8, 10)):
        hits = [k for k in state if re.search(rf"(^|\.)features\.{layer}\.weight$", k)]
        if not hits or state[hits[0]].shape[0] != CONVS[i][0]:
            return None
        convs.append((state[hits[0]], state[hits[0][: -len("weight")] + "bias"]))
    return convs


def _extract_lins(state: Dict[str, np.ndarray]) -> Optional[List[np.ndarray]]:
    lins: List[Optional[np.ndarray]] = [None] * 5
    for k, v in state.items():
        m = re.search(r"lin(\d)\.(?:model\.1\.)?weight$", k)
        if m and int(m.group(1)) < 5:
            lins[int(m.group(1))] = v.reshape(-1)
    return None if any(lin is None for lin in lins) else lins  # type: ignore[return-value]


def _search_dirs() -> List[Path]:
    dirs = []
    env = os.environ.get("LPIPS_WEIGHTS")
    if env:
        dirs.append(Path(env))
    dirs.append(Path.home() / ".cache" / "torch" / "hub" / "checkpoints")
    dirs.append(Path.home() / ".cache" / "torch_nerf_tpu")
    return [d.parent if d.is_file() else d for d in dirs if d.exists()]


def load_weights() -> Optional[LPIPSWeights]:
    """Calibrated LPIPS-alex weights from the places the module docstring
    names, or None."""
    env = os.environ.get("LPIPS_WEIGHTS")
    if env and env.endswith(".npz") and Path(env).is_file():
        return _load_npz(Path(env))
    backbone, lins = None, None
    for d in _search_dirs():
        for f in sorted(d.glob("*.npz")):
            weights = _load_npz(f)
            if weights is not None:
                return weights
        for f in sorted(d.glob("*.pth")) + sorted(d.glob("*.pt")):
            state = _load_torch_state(f)
            if state is None:
                continue
            backbone = backbone or _extract_backbone(state)
            lins = lins or _extract_lins(state)
    if backbone is not None and lins is not None:
        return LPIPSWeights(backbone, lins)
    return None


def _taps(x: torch.Tensor, convs) -> List[torch.Tensor]:
    """The relu1..relu5 activations of NCHW input in LPIPS scaling."""
    taps = []
    for i, ((w, b), (_, _, stride, pad)) in enumerate(zip(convs, CONVS)):
        x = torch.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
        taps.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return taps


def lpips_alex(pred, target, weights: LPIPSWeights, device: Optional[torch.device] = None) -> float:
    """LPIPS between ``(H, W, 3)`` images in [0, 1] (numpy or tensors), on
    ``device``; the JAX package's ``lpips_alex`` and torchmetrics'
    ``LearnedPerceptualImagePatchSimilarity(net_type='alex',
    normalize=True)`` given the same weights."""
    kw = dict(device=device, dtype=torch.float32)
    shift = torch.tensor(_SHIFT, **kw).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, **kw).view(1, 3, 1, 1)
    convs = [(torch.as_tensor(w, **kw), torch.as_tensor(b, **kw)) for w, b in weights.convs]

    def prep(img) -> torch.Tensor:
        x = torch.as_tensor(img).to(**kw).permute(2, 0, 1)[None] * 2.0 - 1.0
        return (x - shift) / scale

    total = 0.0
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for fa, fb, lin in zip(_taps(prep(pred), convs), _taps(prep(target), convs), weights.lins):
            na = fa / torch.sqrt(torch.sum(fa**2, dim=1, keepdim=True) + 1e-10)
            nb = fb / torch.sqrt(torch.sum(fb**2, dim=1, keepdim=True) + 1e-10)
            weighted = torch.sum((na - nb) ** 2 * torch.as_tensor(lin, **kw).view(1, -1, 1, 1), dim=1)
            total += float(torch.mean(weighted))
    return total
