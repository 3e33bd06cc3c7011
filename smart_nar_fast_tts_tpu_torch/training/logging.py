"""Mel figures for the synthesize CLI, without matplotlib.

The JAX package draws a mel with matplotlib (``training/logging.py:
plot_mel``), which the card's machine lacks.  Here a mel is written as a PNG
heat map by a small writer on ``zlib`` and ``struct``: one pixel per (frame,
mel channel), the lowest channel at the bottom, values scaled to the mel's
own range through a viridis-like colour ramp.  The figure's title, axes and
pitch/energy overlays are not drawn yet.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# anchors of a viridis-like ramp, dark (low) to light (high), RGB
_RAMP = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                  [94, 201, 98], [253, 231, 37]], np.float64)


def colorize(values: np.ndarray) -> np.ndarray:
    """(H, W) floats → (H, W, 3) uint8 through the ramp, scaled so that
    the minimum maps to the first anchor and the maximum to the last (a
    constant image maps to the first)."""
    v = np.asarray(values, np.float64)
    lo, hi = float(v.min()), float(v.max())
    x = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    pos = x * (len(_RAMP) - 1)
    i = np.minimum(pos.astype(np.int64), len(_RAMP) - 2)
    frac = (pos - i)[..., None]
    rgb = _RAMP[i] * (1.0 - frac) + _RAMP[i + 1] * frac
    return np.rint(rgb).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as an 8-bit RGB PNG, rows top to bottom,
    filter type 0 on every row."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def save_mel_png(path: str, mel: np.ndarray) -> None:
    """A mel (n_mels, T) as a PNG heat map of T × n_mels pixels, channel 0
    in the bottom row."""
    write_png(path, colorize(np.asarray(mel)[::-1]))
