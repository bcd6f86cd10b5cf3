"""Shared by the metric readers: the card's peaks, and the run's job."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nerfbench import work


def card_peaks(run) -> Optional[Dict[str, float]]:
    """The peaks of the run's card; None off a CUDA card or for a card
    ``peaks.json`` does not hold."""
    if run.device.type != "cuda":
        return None
    return work.peaks(torch.cuda.get_device_name(run.device))


def traced(run, job: str) -> bool:
    return run.cell.job == job and run.trace is not None and run.traced_units > 0
