"""Observability and image IO: metrics logging, step timing, PNG files.

Counterpart of ``torch_nerf_tpu/logging_utils.py``. ``MetricsLogger``
writes ``<log_dir>/metrics.jsonl`` only (the card's host has no
tensorboard); ``StepTimer`` gives steps/s, rays/s and MFU over windows whose
boundaries synchronise with the card. PNG files are written and read with
the standard library (``zlib`` + ``struct``) for hosts without PIL: the
reader takes 8-bit greyscale, RGB and RGBA images, non-interlaced, with any
of the five PNG row filters.
"""

from __future__ import annotations

import json
import struct
import time
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


class MetricsLogger:
    """Appends one JSON object per call to ``<log_dir>/metrics.jsonl``:
    ``{"step", "wall_s", <scalars>}``, ``wall_s`` counted from the logger's
    creation."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a", buffering=1)
        self._t0 = time.perf_counter()

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": int(step), "wall_s": round(time.perf_counter() - self._t0, 3)}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._jsonl.close()


def device_peak_flops(device: Optional[torch.device] = None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of the CUDA card, from its name (NVIDIA's data
    sheets), or None for the CPU and unknown cards."""
    if device is None or device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" in name:
        return 756e12 if "PCIe" in name else 989e12
    if "H200" in name:
        return 989e12
    return None


class StepTimer:
    """Windowed steps/s + rays/s (+ TFLOP/s and MFU) tracker.

    Only the window-boundary stamps feed the rates, and those are taken
    after ``torch.cuda.synchronize()``: kernel launches return before the
    card finishes, so an unsynchronised clock measures the enqueue rate. One
    synchronisation per window of steps.
    """

    def __init__(
        self,
        rays_per_step: int,
        window: int = 50,
        flops_per_step: Optional[float] = None,
        device: Optional[torch.device] = None,
    ):
        self.rays_per_step = rays_per_step
        self.window = window
        self.flops_per_step = flops_per_step
        self.device = device
        self._peak = device_peak_flops(device)
        self._count = 0
        self._last_boundary: Optional[float] = None

    def tick(self) -> Optional[Dict[str, float]]:
        self._count += 1
        if self._count % self.window != 0:
            return None
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        prev, self._last_boundary = self._last_boundary, now
        if prev is None:
            return None
        steps_per_sec = self.window / (now - prev)
        out = {
            "perf/steps_per_sec": steps_per_sec,
            "perf/rays_per_sec": steps_per_sec * self.rays_per_step,
        }
        if self.flops_per_step:
            flops_per_sec = steps_per_sec * self.flops_per_step
            out["perf/tflops"] = flops_per_sec / 1e12
            if self._peak:
                out["perf/mfu"] = flops_per_sec / self._peak
        return out

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, 3|4) or (H, W) uint8 -> PNG bytes (filter 0 on every row)."""
    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct one row (int64 arrays, values 0..255)."""
    if ftype == 0:
        return row
    if ftype == 2:
        return (row + prev) & 0xFF
    if ftype == 1:
        pix = row.reshape(-1, bpp)
        return (np.cumsum(pix, axis=0) & 0xFF).reshape(-1)
    out = np.empty_like(row)
    for x in range(0, row.size, bpp):
        a = out[x - bpp : x] if x else np.zeros(bpp, np.int64)
        b = prev[x : x + bpp]
        if ftype == 3:
            pred = (a + b) >> 1
        elif ftype == 4:
            c = prev[x - bpp : x] if x else np.zeros(bpp, np.int64)
            pred = _paeth(a, b, c)
        else:
            raise ValueError(f"PNG filter type {ftype} is invalid")
        out[x : x + bpp] = (row[x : x + bpp] + pred) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {color_type}, interlace {interlace}"
        )
    c = _CHANNELS[color_type]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).astype(np.int64)
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.int64)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, c)
    return out.astype(np.uint8).reshape(h, w, c)


def save_png(path: str | Path, image: np.ndarray) -> None:
    """Write an (H, W, 3) float [0, 1] image as PNG (same quantization as
    the JAX package: ``clip * 255 + 0.5`` truncated)."""
    arr = np.clip(np.asarray(image), 0.0, 1.0)
    Path(path).write_bytes(encode_png((arr * 255.0 + 0.5).astype(np.uint8)))


def load_png(path: str | Path) -> np.ndarray:
    """Read a PNG file -> (H, W, C) uint8."""
    return decode_png(Path(path).read_bytes())
