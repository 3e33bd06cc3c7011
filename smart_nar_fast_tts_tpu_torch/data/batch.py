"""The padded, static-shape training batch."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Batch(NamedTuple):
    texts: torch.Tensor       # (B, L) int symbol ids
    src_lens: torch.Tensor    # (B,)
    mels: torch.Tensor        # (B, T, n_mels)
    mel_lens: torch.Tensor    # (B,)
    pitch: torch.Tensor       # (B, T) or (B, L) by feature level
    energy: torch.Tensor      # (B, T) or (B, L)
    speakers: Optional[torch.Tensor] = None   # (B,)

    def to(self, device: torch.device) -> "Batch":
        return Batch(*(None if t is None else torch.as_tensor(t).to(device)
                       for t in self))

    def split(self, n: int) -> list["Batch"]:
        """``n`` microbatches of B / n items each, in order."""
        if self.texts.shape[0] % n:
            raise ValueError(f"batch of {self.texts.shape[0]} does not split "
                             f"into {n} microbatches")
        parts = [None if t is None else t.chunk(n) for t in self]
        return [Batch(*(None if p is None else p[i] for p in parts))
                for i in range(n)]
