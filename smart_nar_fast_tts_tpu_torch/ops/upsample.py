"""Length regulation: phoneme-rate → frame-rate features.

- ``hard_upsample`` repeats phoneme i ``d_i`` times.
- ``gaussian_upsample`` is the dense soft upsampler: a (B, L, T) weight
  matrix times x.  It is the plain version of the banded CUDA kernel
  (``kernels/upsample.py``), which computes the same function.
"""

from __future__ import annotations

import torch


def hard_upsample(x: torch.Tensor, durations: torch.Tensor, max_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, D), durations (B, L) → (out (B, T, D) with frames ≥ Σd
    zeroed, mel_len (B,) int32 = min(Σd, T)).  Frame t belongs to phoneme i
    iff cumsum(d)_{i-1} <= t < cumsum(d)_i."""
    cum = torch.cumsum(durations.float(), dim=1)                   # (B, L)
    t = torch.arange(max_len, dtype=torch.float32, device=x.device)
    idx = (cum[:, None, :] <= t[None, :, None]).sum(-1)            # (B, T)
    total = cum[:, -1]
    valid = t[None, :] < total[:, None]
    idx = idx.clamp(0, x.shape[1] - 1)
    gathered = torch.gather(
        x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    out = torch.where(valid[:, :, None], gathered, 0.0)
    mel_len = torch.clamp(total, max=max_len).to(torch.int32)
    return out, mel_len


def gaussian_upsample(x: torch.Tensor, durations: torch.Tensor, max_len: int,
                      phon_valid: torch.Tensor, sigma: float = 10.0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft Gaussian upsampling.

    ``w[b, l, t] ∝ exp(-sigma^-2 (t - c_l)^2)`` with centers
    ``c_l = cumsum(d)_l - d_l/2``, normalised over valid phonemes; frames
    ≥ Σd are zeroed.  Returns (out (B, T, D), mel_len (B,) int32, w (B, L, T)).
    """
    d = durations.float() * phon_valid
    e = torch.cumsum(d, dim=1)
    c = e - 0.5 * d                                                # (B, L)
    t = torch.arange(max_len, dtype=torch.float32, device=x.device)
    dist2 = (t[None, None, :] - c[:, :, None]) ** 2                # (B, L, T)
    w = torch.exp(-(sigma ** -2) * dist2) * phon_valid[:, :, None]
    w = w / (w.sum(dim=1, keepdim=True) + 1e-20)
    total = e[:, -1]
    frame_valid = t[None, :] < total[:, None]
    w = w * frame_valid[:, None, :]
    out = torch.einsum("blt,bld->btd", w, x.float())
    mel_len = torch.clamp(total, max=max_len).to(torch.int32)
    return out.to(x.dtype), mel_len, w
