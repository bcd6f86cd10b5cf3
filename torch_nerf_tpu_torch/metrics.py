"""Image-quality metrics: PSNR, SSIM and LPIPS in torch, and directory
comparison.

Counterpart of ``torch_nerf_tpu/metrics.py:29-185``: PSNR with data range
1.0; SSIM with an 11x11 Gaussian window (sigma 1.5), K1 0.01, K2 0.03, the
window shrunk (odd) for tiny images; directories compared file by file with
white-background compositing of RGBA. Both compute in float64 on the given
device. LPIPS (``lpips.py``, float32) runs only where calibrated weights are
found (:func:`lpips_available`); otherwise it is reported as unavailable.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch_nerf_tpu_torch import lpips as lpips_mod
from torch_nerf_tpu_torch.logging_utils import load_png


def _as64(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float64)


def psnr(pred, target, data_range: float = 1.0, device: Optional[torch.device] = None) -> float:
    """PSNR in dB between images of matching shape, values in [0, range]."""
    pred, target = _as64(pred, device), _as64(target, device)
    mse = torch.mean((pred - target) ** 2).item()
    if mse == 0:
        return float("inf")
    return float(10.0 * torch.log10(torch.tensor(data_range**2 / mse, dtype=torch.float64)))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float64, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(
    pred,
    target,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    device: Optional[torch.device] = None,
) -> float:
    """Mean SSIM over channels; images (H, W, C) or (H, W)."""
    pred, target = _as64(pred, device), _as64(target, device)
    if pred.dim() == 2:
        pred, target = pred[..., None], target[..., None]
    max_k = min(pred.shape[0], pred.shape[1])
    if kernel_size > max_k:
        kernel_size = max_k if max_k % 2 == 1 else max_k - 1
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kernel = _gaussian_kernel(kernel_size, sigma, pred.device)[None, None]

    def filt(img: torch.Tensor) -> torch.Tensor:  # (H, W, C) -> valid (C, H', W')
        return F.conv2d(img.permute(2, 0, 1)[:, None], kernel)[:, 0]

    mu_x, mu_y = filt(pred), filt(target)
    var_x = filt(pred * pred) - mu_x**2
    var_y = filt(target * target) - mu_y**2
    cov_xy = filt(pred * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * cov_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2)
    return float(torch.mean((num / den).mean(dim=(1, 2))))


def lpips_available() -> bool:
    """Whether calibrated LPIPS-alex weights are found (the search of
    ``lpips.load_weights``: ``$LPIPS_WEIGHTS``, then the torch-hub cache)."""
    return lpips_mod.load_weights() is not None


def lpips(
    pred, target, weights: Optional[lpips_mod.LPIPSWeights] = None, device: Optional[torch.device] = None
) -> Optional[float]:
    """LPIPS(alex) between ``(H, W, 3)`` images in [0, 1] with ``weights``
    (searched for when not given), or None when there are none."""
    weights = weights or lpips_mod.load_weights()
    if weights is None:
        return None
    return lpips_mod.lpips_alex(pred, target, weights, device=device)


def _to_rgb(pixels) -> torch.Tensor:
    arr = torch.from_numpy(pixels).to(torch.float32) / 255.0
    if arr.shape[-1] == 4:
        alpha = arr[..., -1]
        arr = arr.clone()
        arr[alpha == 0.0, :] = 1.0  # white background
        arr = arr[..., :3]
    elif arr.shape[-1] == 1:
        arr = arr[..., 0]
    return arr


def _resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if img.shape[:2] == (h, w):
        return img
    chw = img.permute(2, 0, 1)[None] if img.dim() == 3 else img[None, None]
    out = F.interpolate(chw, size=(h, w), mode="bicubic", antialias=True, align_corners=False)
    out = out[0].permute(1, 2, 0) if img.dim() == 3 else out[0, 0]
    return out.clamp(0.0, 1.0)


def _load_image_pair(file1: Path, file2: Path) -> Tuple[torch.Tensor, torch.Tensor]:
    a, b = _to_rgb(load_png(file1)), _to_rgb(load_png(file2))
    h, w = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
    return _resize(a, h, w), _resize(b, h, w)


def compare_directories(
    pred_dir: str | Path, target_dir: str | Path, device: Optional[torch.device] = None
) -> Dict[str, float]:
    """PSNR/SSIM averaged over images paired by file name, and ``lpips``
    where calibrated weights are found."""
    pred_dir, target_dir = Path(pred_dir), Path(target_dir)
    if not pred_dir.exists() or not target_dir.exists():
        raise FileNotFoundError(f"{pred_dir} or {target_dir} does not exist")
    weights = lpips_mod.load_weights()
    psnrs, ssims, lpipss = [], [], []
    for file1 in sorted(pred_dir.iterdir()):
        file2 = target_dir / file1.name
        if not file2.exists():
            raise FileNotFoundError(f"Missing pair for {file1.name} in {target_dir}")
        a, b = _load_image_pair(file1, file2)
        psnrs.append(psnr(a, b, device=device))
        ssims.append(ssim(a, b, device=device))
        if weights is not None:
            lpipss.append(lpips_mod.lpips_alex(a, b, weights, device=device))
    if not psnrs:
        raise FileNotFoundError(f"no images in {pred_dir}")
    out = {"psnr": sum(psnrs) / len(psnrs), "ssim": sum(ssims) / len(ssims)}
    if lpipss:
        out["lpips"] = sum(lpipss) / len(lpipss)
    return out
