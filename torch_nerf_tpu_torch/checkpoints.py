"""Checkpoint save/load with ``torch.save``.

Counterpart of ``torch_nerf_tpu/checkpoints.py:23-109``: checkpoints named
by step under ``<log_dir>/ckpt/``, latest wins on restore. A checkpoint
holds ``{"step", "params"}`` in the public parameter layout and, when saved
from a trainer, the ``"optimizer"`` (Adam's moments and step counts) and
``"scheduler"`` state dicts, so a resumed run continues the moments and the
learning rate exactly. A checkpoint with params only (as rendering needs)
still loads.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Optional

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
) -> Path:
    """Write ``<log_dir>/ckpt/ckpt_<step:06d>.pt`` (atomically), tensors on
    the CPU."""
    path = ckpt_dir(log_dir) / f"ckpt_{int(step):06d}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp")
    state = {"step": int(step), "params": _to_device(params, torch.device("cpu"))}
    if optimizer is not None:
        state["optimizer"] = _to_device(optimizer.state_dict(), torch.device("cpu"))
    if scheduler is not None:
        state["scheduler"] = scheduler.state_dict()
    torch.save(state, tmp)
    tmp.replace(path)
    return path


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
    ``load_state_dict`` moves them to the parameters' device)."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    out = {"step": int(state["step"]), "params": _to_device(state["params"], device)}
    for key in ("optimizer", "scheduler"):
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
