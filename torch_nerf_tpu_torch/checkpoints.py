"""Checkpoint save/load with ``torch.save``.

Counterpart of ``torch_nerf_tpu/checkpoints.py:23-109``: checkpoints named
by step under ``<log_dir>/ckpt/``, latest wins on restore. A checkpoint
holds ``{"step", "params"}`` in the public parameter layout and, when saved
from a trainer, the ``"optimizer"`` (Adam's moments and step counts) and
``"scheduler"`` state dicts, so a resumed run continues the moments and the
learning rate exactly. A checkpoint with params only (as rendering needs)
still loads. A multi-scene run's checkpoint holds its stacked ``(S, ...)``
params and optimizer state, and ``"num_scenes"``; a checkpoint without that
key is a single scene's.

An occupancy-pruned run keeps its grid beside the checkpoint, in the sidecar
``ckpt_<step:06d>.occ.npy``: the flat ``(R^3,)`` float32 grid as ``np.save``
writes it (the JAX package's sidecar format), written atomically, so a
resume restores it bit for bit. A checkpoint without one still loads.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

_CKPT_RE = re.compile(r"^ckpt_(\d{6,})\.pt$")


def ckpt_dir(log_dir: str | Path) -> Path:
    return Path(log_dir) / "ckpt"


def save_checkpoint(
    log_dir: str | Path,
    step: int,
    params: Dict[str, Any],
    optimizer: Optional[torch.optim.Optimizer] = None,
    scheduler: Optional[Any] = None,
    occ_grid: Optional[torch.Tensor] = None,
    num_scenes: Optional[int] = None,
) -> Path:
    """Write ``<log_dir>/ckpt/ckpt_<step:06d>.pt`` (atomically), tensors on
    the CPU, and ``occ_grid``'s sidecar where given; ``num_scenes`` marks a
    multi-scene run's stacked state."""
    path = ckpt_dir(log_dir) / f"ckpt_{int(step):06d}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp")
    state = {"step": int(step), "params": _to_device(params, torch.device("cpu"))}
    if optimizer is not None:
        state["optimizer"] = _to_device(optimizer.state_dict(), torch.device("cpu"))
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    if num_scenes is not None:
        state["num_scenes"] = int(num_scenes)
    torch.save(state, tmp)
    tmp.replace(path)
    if occ_grid is not None:
        sidecar = occ_sidecar_path(path)
        tmp = sidecar.with_name(f".{sidecar.name}.tmp")
        with open(tmp, "wb") as f:  # np.save on a handle keeps the exact name
            np.save(f, occ_grid.detach().cpu().numpy())
        tmp.replace(sidecar)
    return path


def occ_sidecar_path(ckpt_path: str | Path) -> Path:
    """``ckpt_<step>.occ.npy`` beside ``ckpt_<step>.pt``."""
    ckpt_path = Path(ckpt_path)
    return ckpt_path.with_name(f"{ckpt_path.stem}.occ.npy")


def load_occupancy_grid(ckpt_path: str | Path, device: Optional[torch.device] = None) -> Optional[torch.Tensor]:
    """The grid saved beside ``ckpt_path`` on ``device``, or None."""
    sidecar = occ_sidecar_path(ckpt_path)
    if not sidecar.exists():
        return None
    return torch.as_tensor(np.load(sidecar), device=device)


def latest_checkpoint(log_dir: str | Path) -> Optional[Path]:
    """Lexicographically-latest checkpoint file, or None."""
    directory = ckpt_dir(log_dir)
    if not directory.exists():
        return None
    candidates = sorted(p for p in directory.iterdir() if p.is_file() and _CKPT_RE.match(p.name))
    return candidates[-1] if candidates else None


def load_checkpoint(path: str | Path, device: Optional[torch.device] = None) -> Dict[str, Any]:
    """``{"step", "params"}`` with the params moved to ``device``, plus
    ``"optimizer"`` and ``"scheduler"`` state dicts where saved (on the CPU;
    ``load_state_dict`` moves them to the parameters' device) and
    ``"num_scenes"`` where it is a multi-scene run's."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    out = {"step": int(state["step"]), "params": _to_device(state["params"], device)}
    for key in ("optimizer", "scheduler", "num_scenes"):
        if key in state:
            out[key] = state[key]
    return out


def restore_latest(log_dir: str | Path, device: Optional[torch.device] = None):
    """The latest checkpoint under ``log_dir``, or None."""
    path = latest_checkpoint(log_dir)
    return None if path is None else load_checkpoint(path, device)


def _to_device(tree: Any, device: Optional[torch.device]) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device) if device is not None else tree.detach()
    return tree
