"""PNG write and read with the standard library (``zlib`` + ``struct``).

Counterpart of ``torch_nerf_tpu/logging_utils.py:142-147`` (``save_png``)
for hosts without PIL. The reader takes 8-bit greyscale, RGB and RGBA
images, non-interlaced, with any of the five PNG row filters.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

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
