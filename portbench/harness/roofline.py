"""The card's peaks and each kernel's least time.

Peaks: NVIDIA's H100 SXM data sheet, dense, at its 700 W limit: HBM
3.35 TB/s; 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside
the tensor cores.  A kernel's bound is max(bytes / bandwidth, operations /
the peak of the units it computes on), each input read once and each
output written once, the operations those inputs need (valid query rows
and keys, frames below Σd): the bounds of the kernel table in ``PERF.md``.
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
F32 = 4

# the whole step's model FLOPs are held to the TF32 tensor-core rate: the
# configurations compute in float32, which no unit of the card runs faster
MFU_PEAK = TF32_FLOPS


def upsample_seconds(B, L, D, T, durations, src_lens, sigma):
    """Banded Gaussian upsampling of B items (L phonemes of width D, T
    frames): reads x, durations and the mask, writes the (B, T, D) output
    and mel_len; per frame below Σd, 2·D operations for each phoneme
    within √104·σ of it (f32, CUDA cores)."""
    bytes_ = F32 * (B * L * D + 2 * B * L + B * T * D + B)
    band = math.sqrt(104.0) * sigma
    pairs = 0
    for i in range(B):
        d = np.asarray(durations[i][:int(src_lens[i])], dtype=np.float64)
        e = np.cumsum(d)
        c = e - 0.5 * d
        total = min(float(e[-1]) if len(e) else 0.0, T)
        lo = np.clip(np.ceil(c - band), 0, total)
        hi = np.clip(np.floor(c + band) + 1, 0, total)
        pairs += float(np.maximum(hi - lo, 0).sum())
    return max(bytes_ / HBM_BYTES_S, 2 * D * pairs / F32_FLOPS)


def flash_seconds(B, H, T, D, lens):
    """Flash self-attention over T positions, each item's queries and keys
    valid up to its length: f32 q, k, v read and out written over the
    valid rows, the mask read; QKᵀ and PV for each valid query row against
    the valid keys, on bf16 tensor cores."""
    n = np.minimum(np.asarray(lens, dtype=np.float64), T)
    bytes_ = F32 * 4 * H * D * float(n.sum()) + B * T
    ops = 4 * H * D * float(np.sum(n * n))
    return max(bytes_ / HBM_BYTES_S, ops / BF16_FLOPS)


def alignment_seconds(B, H, T, L, D, src_lens, mel_lens):
    """The alignment kernel's forward: f32 q (the valid of T mel rows), k
    and v (the valid of L text rows) read, out, the argmax and the guided
    numerator written for the valid mel rows, the text mask and lengths
    read; QKᵀ and PV for each valid mel row against the valid keys in
    3xTF32 (three TF32 products each)."""
    t = np.minimum(np.asarray(mel_lens, dtype=np.float64), T)
    keys = np.minimum(np.asarray(src_lens, dtype=np.float64), L)
    bytes_ = F32 * (2 * H * D * float(t.sum()) + 2 * H * D * float(keys.sum())
                    + float(t.sum()) + B) + float(keys.sum()) + 8 * B
    ops = 3 * 4 * H * D * float(np.sum(t * keys))
    return max(bytes_ / HBM_BYTES_S, ops / TF32_FLOPS)


def resblock_seconds(B, convs) -> float:
    """Least time of a forward's resblock convolutions at B items, each
    conv (n samples, C channels, k taps, reads: the (B, C, n) tensors it
    reads besides its input) as the vocoder's family lists them: its
    input and output once, what it reads besides, and its weights once;
    3·2·B·n·C·C·k operations in 3xTF32 (three TF32 products each), the
    float32-accurate route on tensor cores (on the CUDA cores alone, at
    67 TFLOP/s, the least time is longer still)."""
    total = 0.0
    for n, c, k, reads in convs:
        bytes_ = F32 * (B * n * c * (2 + reads) + c * c * k + c)
        ops = 3 * 2 * B * n * c * c * k
        total += max(bytes_ / HBM_BYTES_S, ops / TF32_FLOPS)
    return total
