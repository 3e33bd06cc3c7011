"""Sinusoidal positional encodings: sin on even dims, cos on odd dims,
``angle[pos, i] = pos / 10000^(2*(i//2)/d)``, computed in float64 on the host
and stored as float32, as the JAX package does."""

from __future__ import annotations

import numpy as np
import torch


def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """(n_position, d_hid) float32 sinusoid table."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.empty((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def sinusoid_rows(n_position: int, d_hid: int,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """The table of :func:`sinusoid_table` as torch operations on
    ``device`` (float64, stored as float32), for lengths past a model's PE
    buffer: an exported program computes it and holds no table of its own.
    Torch's float64 ``sin``/``cos`` may round a last bit apart from
    numpy's."""
    pos = torch.arange(n_position, dtype=torch.float64, device=device)
    dim = torch.arange(d_hid, dtype=torch.float64, device=device)
    angle = pos[:, None] / torch.pow(10000.0, 2.0 * torch.div(
        dim, 2, rounding_mode="floor") / d_hid)[None, :]
    even = (torch.arange(d_hid, device=device) % 2 == 0)[None, :]
    return torch.where(even, torch.sin(angle), torch.cos(angle)).float()
