"""Sinusoidal positional encodings: sin on even dims, cos on odd dims,
``angle[pos, i] = pos / 10000^(2*(i//2)/d)``, computed in float64 on the host
and stored as float32, as the JAX package does."""

from __future__ import annotations

import numpy as np


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """(n_position, d_hid) float32 sinusoid table."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.empty((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)
