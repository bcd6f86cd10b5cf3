"""Evaluation CLI: metrics between two image directories.

Counterpart of ``torch_nerf_tpu/runners/evaluate.py`` plus ``--device``
(default: the CUDA card): PSNR and SSIM always, LPIPS where calibrated
weights are found (``torch_nerf_tpu_torch/lpips.py``: ``$LPIPS_WEIGHTS``,
then the torch-hub cache).

    python -m torch_nerf_tpu_torch.runners.evaluate PRED_DIR GT_DIR [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from torch_nerf_tpu_torch import metrics
from torch_nerf_tpu_torch.device import resolve_device


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Compare two image directories.")
    parser.add_argument("dir1", type=str, help="Path to the first directory.")
    parser.add_argument("dir2", type=str, help="Path to the second directory.")
    parser.add_argument("--device", default=None, help="cuda (default, the card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    out = metrics.compare_directories(Path(args.dir1), Path(args.dir2), device=device)
    if "lpips" in out:
        print(f"LPIPS: {out['lpips']:.4f}")
    else:
        print(
            "LPIPS: unavailable — no calibrated weights found (set "
            "$LPIPS_WEIGHTS or place alexnet/lin checkpoints in "
            "~/.cache/torch/hub/checkpoints/; see torch_nerf_tpu_torch/lpips.py)"
        )
    print(f"PSNR: {out['psnr']:.4f}")
    print(f"SSIM: {out['ssim']:.4f}")
    print("Done.")
    return out


if __name__ == "__main__":
    main()
