"""Fused STFT → log-mel: the CUDA kernel ``csrc/log_mel.cu``, its plain
version :func:`~..audio.stft.mel_spectrogram`, and
:func:`log_mel_fft_reference`, the kernel's schedule in float64 torch.

The kernel replaces the TPU kernel ``fused_log_mel`` of
``smart_nar_fast_tts_tpu/ops/pallas/stft.py``.  It takes the real FFT of
each windowed frame in f64: a complex FFT of n_fft/2 points on the (even,
odd) sample pairs, in Stockham radix-4 stages (one radix-2 stage first when
log2(n_fft/2) is odd), then the split step to n_fft/2 + 1 bins; power,
magnitude and the energy in f64; the mel sums over each filter's contiguous
bin range in f64, rounded to f32; then ``log(max(·, clip))`` in f32, as
the TPU kernel.  The window, twiddles and mel ranges are host tables built
in float64 (:func:`log_mel_tables`).  Why f64: an f32 FFT rounds quiet bins
(~110 dB below a frame's loudest) too coarsely for log compression; cuFFT's
f32 log-mel is 2.1e-3 from float64 there.

:func:`log_mel_fft_reference` runs the same stages, twiddle table and mel
table in float64 torch, vectorised over frames, then the same f32
epilogue: the tests hold the kernel to it and to the float64 plain version.
The port itself never calls it.

The TPU kernel takes any n_fft; the FFT kernel takes powers of two from
32 to 4096.  Every other n_fft goes to a second kernel of the same source,
a direct real DFT in f64 from the same twiddle table (bin k = Σ_j x_j
W^(jk mod n_fft), in j order), with the same power, energy, mel sums and
f32 epilogue; :func:`log_mel_dft_reference` is its float64-torch twin.
``fused_log_mel.launches`` counts the FFT kernel's launches,
``.dft_launches`` the DFT kernel's.

Forward only, as the TPU kernel (no ``custom_vjp``): both call sites of the
GAN step take no gradient through it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..audio.stft import MelSpectrogramConfig, frame_signal, mel_spectrogram
from . import _build

# the n_fft the FFT kernel takes: powers of two in this range (every other
# n_fft from 2 up goes to the DFT kernel)
MIN_N_FFT, MAX_N_FFT = 32, 4096

# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_SIGNATURES = {
    "log_mel_forward": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "log_mel_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "log_mel_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "log_mel_dft_forward": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "log_mel_dft_max_n_fft": ([], ctypes.c_int),
}


def uses_fft(n_fft: int) -> bool:
    """Whether the FFT kernel takes n_fft (a power of two in [MIN_N_FFT,
    MAX_N_FFT]); every other n_fft goes to the DFT kernel."""
    return MIN_N_FFT <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0


def check_n_fft(n_fft: int) -> None:
    """Raise unless the FFT kernel takes n_fft."""
    if not uses_fft(n_fft):
        raise ValueError(f"fused_log_mel: n_fft {n_fft} must be a power of "
                         f"two from {MIN_N_FFT} to {MAX_N_FFT}")


def fft_radices(m: int) -> list[int]:
    """The Stockham stages of an m-point FFT (m a power of two): one
    radix-2 stage first when log2(m) is odd, then radix-4 stages."""
    k = m.bit_length() - 1
    return [2] * (k % 2) + [4] * (k // 2)


@dataclass(frozen=True)
class LogMelTables:
    """Host tables of the kernel, as numpy arrays.

    - ``window`` (n_fft,) float64: ``cfg.window``.
    - ``twiddles`` (n_fft, 2) float64: re, im of exp(-2πik/n_fft).  The FFT
      of n_fft/2 points takes W_{n_fft/2}^j as row 2j; the split step takes
      row k.
    - ``mel_ranges`` (n_mels, 3) int32: each filter's first nonzero bin,
      the count of bins up to its last nonzero one (0 for an empty filter),
      and the offset of its weights in ``mel_weights``.
    - ``mel_weights`` float32: ``cfg.mel_basis``'s own values over those
      ranges, packed filter after filter.
    """
    window: np.ndarray
    twiddles: np.ndarray
    mel_ranges: np.ndarray
    mel_weights: np.ndarray


def log_mel_tables(cfg: MelSpectrogramConfig) -> LogMelTables:
    n = cfg.n_fft
    ang = -2.0 * np.pi * np.arange(n) / n
    basis = np.asarray(cfg.mel_basis, np.float32)
    ranges, weights, offset = [], [], 0
    for row in basis:
        nz = np.flatnonzero(row)
        start, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size \
            else (0, 0)
        ranges.append((start, count, offset))
        weights.append(row[start:start + count])
        offset += count
    return LogMelTables(
        window=np.asarray(cfg.window, np.float64),
        twiddles=np.stack([np.cos(ang), np.sin(ang)], axis=1),
        mel_ranges=np.asarray(ranges, np.int32).reshape(-1, 3),
        mel_weights=np.concatenate(weights).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _tables_on(cfg: MelSpectrogramConfig, device: torch.device
               ) -> tuple[torch.Tensor, ...]:
    t = log_mel_tables(cfg)
    return tuple(torch.from_numpy(a).to(device) for a in (
        t.window, t.twiddles, t.mel_ranges, t.mel_weights))


def num_frames(n_samples: int, cfg: MelSpectrogramConfig) -> int:
    """Frames of a centred STFT of ``n_samples`` samples."""
    return 1 + (n_samples + 2 * (cfg.n_fft // 2) - cfg.n_fft) \
        // cfg.hop_length


def _stockham_fft(z: torch.Tensor, w_n: torch.Tensor) -> torch.Tensor:
    """Forward FFT over the last axis of complex z (..., m) by the kernel's
    stages; ``w_n`` (2m,) complex holds exp(-2πik/(2m)).  At a stage of
    length n and stride s (n·s = m), input q + s·(p + k·n/r) goes into
    butterfly (p, q), and output k of that butterfly, times W_n^{kp}
    = w_n[2·k·p·s], goes to q + s·(r·p + k)."""
    lead, m = z.shape[:-1], z.shape[-1]
    n, s = m, 1
    for r in fft_radices(m):
        q = n // r
        x = z.reshape(*lead, r, q, s)
        p = torch.arange(q, device=z.device)
        tw = [w_n[2 * k * p * s][:, None] for k in range(1, r)]
        if r == 2:
            a, b = x.unbind(-3)
            y = (a + b, (a - b) * tw[0])
        else:
            a, b, c, d = x.unbind(-3)
            apc, amc, bpd, jbmd = a + c, a - c, b + d, 1j * (b - d)
            y = (apc + bpd, (amc - jbmd) * tw[0], (apc - bpd) * tw[1],
                 (amc + jbmd) * tw[2])
        z = torch.stack(y, dim=-2).reshape(*lead, m)
        n, s = q, s * r
    return z


def log_mel_fft_reference(y: torch.Tensor, cfg: MelSpectrogramConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) float32 waveform → (log-mel (B, n_mels, F), energy (B, F)),
    float32, by the kernel's schedule: the window, the radix stages and the
    split step with the kernel's tables, power, magnitude, energy and the
    sparse mel sums in float64; the mel value rounded to float32, then
    ``log(max(·, clip))`` in float32."""
    check_n_fft(cfg.n_fft)
    window, twiddles, ranges, weights = _tables_on(cfg, y.device)
    m = cfg.n_fft // 2
    w_n = torch.complex(twiddles[:, 0], twiddles[:, 1])
    frames = frame_signal(y.double(), cfg.n_fft, cfg.hop_length) * window
    z = _stockham_fft(torch.complex(frames[..., 0::2], frames[..., 1::2]),
                      w_n)
    k = torch.arange(m + 1, device=y.device)
    zk = z[..., k % m]
    zc = z[..., (m - k) % m].conj()
    spec = 0.5 * (zk + zc) - 0.5j * (zk - zc) * w_n[k]
    power = spec.real ** 2 + spec.imag ** 2                  # (B, F, m + 1)
    return _mel_epilogue(power, ranges, weights, cfg)


def log_mel_dft_reference(y: torch.Tensor, cfg: MelSpectrogramConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) float32 waveform → (log-mel (B, n_mels, F), energy (B, F)),
    float32, by the DFT kernel's schedule, for any n_fft: the windowed
    frame's direct DFT from the kernel's twiddle table (bin k takes row
    jk mod n_fft for sample j), power, magnitude, energy and the sparse mel
    sums in float64; the mel value rounded to float32, then
    ``log(max(·, clip))`` in float32."""
    window, twiddles, ranges, weights = _tables_on(cfg, y.device)
    n = cfg.n_fft
    j = torch.arange(n, device=y.device)
    k = torch.arange(n // 2 + 1, device=y.device)
    rows = twiddles[(j[:, None] * k[None, :]) % n]           # (n, bins, 2)
    frames = frame_signal(y.double(), n, cfg.hop_length) * window
    re, im = frames @ rows[..., 0], frames @ rows[..., 1]
    return _mel_epilogue(re ** 2 + im ** 2, ranges, weights, cfg)


def _mel_epilogue(power: torch.Tensor, ranges: torch.Tensor,
                  weights: torch.Tensor, cfg: MelSpectrogramConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 power (B, F, bins) → the kernels' f32 outputs: the sparse
    mel sums of the magnitudes in float64, rounded to float32, then
    ``log(max(·, clip))``; the energy √Σ power."""
    # each filter's range as a padded gather; pads weigh 0
    start, count, offset = ranges.long().unbind(1)
    j = torch.arange(max(int(count.max()), 1), device=power.device)
    inside = j[None, :] < count[:, None]
    bins = torch.where(inside, start[:, None] + j, 0)
    wpad = torch.where(inside, weights.double()[
        torch.where(inside, offset[:, None] + j, 0)], 0.0)
    mel = (power.sqrt()[..., bins] * wpad).sum(-1).float()   # (B, F, n_mels)
    mel = torch.log(torch.clamp(mel, min=cfg.compression_clip))
    energy = power.sum(-1).sqrt().float()
    return mel.transpose(1, 2).contiguous(), energy


def fused_log_mel(y: torch.Tensor, cfg: MelSpectrogramConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) waveform → (log-mel (B, n_mels, F), energy (B, F)), as
    :func:`~..audio.stft.mel_spectrogram`.

    A CPU tensor takes that plain version.  A CUDA tensor launches the
    FFT kernel for n_fft a power of two from 32 to 4096 and the DFT kernel
    for any other n_fft: y contiguous float32, S > n_fft/2.  No gradient
    flows through the kernels."""
    if y.device.type == "cpu":
        return mel_spectrogram(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"fused_log_mel: unsupported device {y.device}")
    if y.ndim != 2 or y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("fused_log_mel: y must be contiguous (B, S) "
                         f"float32, got {tuple(y.shape)} {y.dtype}")
    B, S = y.shape
    fft = uses_fft(cfg.n_fft)
    lib = _build.load("log_mel", _SIGNATURES)
    if not fft and not 2 <= cfg.n_fft <= lib.log_mel_dft_max_n_fft():
        raise ValueError(f"fused_log_mel: n_fft {cfg.n_fft} outside 2 to "
                         f"{lib.log_mel_dft_max_n_fft()}")
    if S <= cfg.n_fft // 2:
        raise ValueError(f"fused_log_mel: n_fft/2 = {cfg.n_fft // 2} must "
                         f"be below S = {S} (reflect padding)")
    F = num_frames(S, cfg)
    window, twiddles, ranges, weights = _tables_on(cfg, y.device)
    mel = torch.empty((B, cfg.n_mels, F), dtype=torch.float32,
                      device=y.device)
    energy = torch.empty((B, F), dtype=torch.float32, device=y.device)
    launch = lib.log_mel_forward if fft else lib.log_mel_dft_forward
    with torch.cuda.device(y.device):
        status = launch(
            y.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
            ranges.data_ptr(), weights.data_ptr(), mel.data_ptr(),
            energy.data_ptr(), B, S, F, cfg.n_fft, cfg.hop_length,
            cfg.n_mels, float(cfg.compression_clip),
            torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("fused_log_mel: launch failed: "
                           + lib.log_mel_error_string(status).decode())
    if fft:
        fused_log_mel.launches += 1
    else:
        fused_log_mel.dft_launches += 1
    return mel, energy


fused_log_mel.launches = 0
fused_log_mel.dft_launches = 0
