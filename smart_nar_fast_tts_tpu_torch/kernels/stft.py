"""Fused STFT → log-mel: the CUDA kernels of ``csrc/log_mel.cu``, their
plain version :func:`~..audio.stft.mel_spectrogram`, and
:func:`log_mel_fft_reference`, the FFT kernels' schedule in float64 torch.

The kernels replace the TPU kernel ``fused_log_mel`` of
``smart_nar_fast_tts_tpu/ops/pallas/stft.py``, which takes any n_fft.  Each
takes the real FFT of each windowed frame in f64, one frame a block: power,
magnitude and the energy in f64; the mel sums over each filter's
contiguous bin range in f64, rounded to f32; then ``log(max(·, clip))`` in
f32, as the TPU kernel.  The window, twiddles and mel ranges are host
tables built in float64 (:func:`log_mel_tables`).  Why f64: an f32 FFT
rounds quiet bins (~110 dB below a frame's loudest) too coarsely for log
compression; cuFFT's f32 log-mel is 2.1e-3 from float64 there.  What bounds
them on the H100 is latency (the launch, the loads and the barriers between
the FFT's stages), not bytes or operations: the design spreads the frames
over every SM, one block a frame, and keeps every stage in shared memory.

Three routes (:func:`log_mel_route`):

- ``fft``, n_fft a power of two from 32 to 4096 (``log_mel_kernel``): a
  complex FFT of n_fft/2 points on the (even, odd) sample pairs in Stockham
  radix-4 stages (one radix-2 stage first when log2(n_fft/2) is odd), then
  the split step to n_fft/2 + 1 bins.  ``fused_log_mel.launches`` counts it.
- ``mixed``, any other n_fft whose two f64 buffers fit a block's shared
  memory: every even n_fft up to 14,526, every odd one up to 7,263
  (``log_mel_mixed_kernel``).  The Stockham stages follow :func:`fft_plan`,
  with butterflies for radices 2, 3, 4, 5 and 7 and a length-r DFT spread
  over (butterfly, output) pairs for any larger prime.  An even n_fft packs
  its samples and ends in the split step as above; an odd one takes an
  n_fft-point complex FFT of the real frame and keeps bins 0 to
  (n_fft - 1)/2.  ``.mixed_launches`` counts it.
- ``dft``, the odd n_fft past that, up to 14,527 (``log_mel_dft_kernel``):
  a direct real DFT from the same twiddle table (bin k = Σ_j x_j
  W^(jk mod n_fft), in j order); :func:`log_mel_dft_reference` is its
  float64-torch twin.  ``.dft_launches`` counts it.

:func:`log_mel_fft_reference` runs the first two routes' stages, twiddle
table and mel table in float64 torch, vectorised over frames, then the same
f32 epilogue: the tests hold the kernels to it and to the float64 plain
version.  The port itself never calls it.

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

# the n_fft the first FFT kernel takes: powers of two in this range
MIN_N_FFT, MAX_N_FFT = 32, 4096
# shared memory a block may take (csrc/log_mel.cu MAX_SMEM)
MAX_SMEM = 232448

# pointers and the stream as c_void_p: ctypes would pass a bare int as 32 bits
_FORWARD = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                         ctypes.c_void_p]
_SIGNATURES = {
    "log_mel_forward": (_FORWARD, ctypes.c_int),
    "log_mel_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "log_mel_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "log_mel_mixed_forward": (
        _FORWARD[:7] + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        + _FORWARD[7:],
        ctypes.c_int),
    "log_mel_mixed_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "log_mel_dft_forward": (_FORWARD, ctypes.c_int),
    "log_mel_dft_smem_bytes": ([ctypes.c_int], ctypes.c_int),
    "log_mel_max_smem_bytes": ([], ctypes.c_int),
}


def mixed_smem_bytes(n_fft: int) -> int:
    """Shared memory of a mixed-radix block: two buffers of the FFT's
    points in complex f64 (n_fft/2 of them for an even n_fft, + 16 bytes
    for the bins' power and magnitude; n_fft for an odd one)."""
    return 32 * n_fft if n_fft % 2 else 16 * n_fft + 16


def dft_smem_bytes(n_fft: int) -> int:
    """Shared memory of a DFT block: the frame, the bins' power and
    magnitude, in f64."""
    return 8 * (n_fft + 2 * (n_fft // 2 + 1))


def log_mel_route(n_fft: int) -> str:
    """The kernel that takes n_fft: ``fft`` (a power of two from 32 to
    4096), ``mixed`` (any other n_fft from 2 whose buffers fit) or ``dft``
    (an odd n_fft past those, while its frame fits); raises past them."""
    if MIN_N_FFT <= n_fft <= MAX_N_FFT and n_fft & (n_fft - 1) == 0:
        return "fft"
    if n_fft >= 2 and mixed_smem_bytes(n_fft) <= MAX_SMEM:
        return "mixed"
    if n_fft >= 2 and dft_smem_bytes(n_fft) <= MAX_SMEM:
        return "dft"
    raise ValueError(f"fused_log_mel: n_fft {n_fft} outside 2 to "
                     f"{max_odd_n_fft('dft')}")


def max_odd_n_fft(route: str) -> int:
    """The largest odd n_fft of ``route`` (``mixed`` or ``dft``): an odd
    n_fft takes the most shared memory for its length."""
    smem = mixed_smem_bytes if route == "mixed" else dft_smem_bytes
    n = MAX_SMEM // 16 * 2 + 1
    while smem(n) > MAX_SMEM:
        n -= 2
    return n


def check_n_fft(n_fft: int) -> None:
    """Raise unless an FFT kernel (``fft`` or ``mixed``) takes n_fft."""
    if log_mel_route(n_fft) == "dft":
        raise ValueError(f"fused_log_mel: n_fft {n_fft} takes the DFT "
                         f"kernel: odd n_fft past "
                         f"{max_odd_n_fft('mixed')} have no FFT route")


def fft_plan(m: int) -> list[int]:
    """The Stockham stages of an m-point FFT, first stage first.  A power
    of two: one radix-2 stage first when log2(m) is odd, then radix-4
    stages.  Any other m: radix-4 stages, one radix 2 if a factor 2 is
    left, then the factors 3, 5, 7 and any larger primes in ascending
    order."""
    if m & (m - 1) == 0:
        k = m.bit_length() - 1
        return [2] * (k % 2) + [4] * (k // 2)
    plan = []
    while m % 4 == 0:
        plan.append(4)
        m //= 4
    if m % 2 == 0:
        plan.append(2)
        m //= 2
    f = 3
    while f * f <= m:
        while m % f == 0:
            plan.append(f)
            m //= f
        f += 2
    return plan + [m] * (m > 1)


@dataclass(frozen=True)
class LogMelTables:
    """Host tables of the kernel, as numpy arrays.

    - ``window`` (n_fft,) float64: ``cfg.window``.
    - ``twiddles`` (n_fft, 2) float64: re, im of exp(-2πik/n_fft).  The FFT
      of n_fft/2 points (even n_fft) takes W_{n_fft/2}^j as row 2j, the
      split step row k; the FFT of n_fft points (odd n_fft) row j.
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
    """Forward FFT over the last axis of complex z (..., m) by the kernels'
    stages (:func:`fft_plan`); ``w_n`` (N,) complex holds exp(-2πik/N) for
    N a multiple of m, so that W_m^x = w_n[x·N/m].  At a stage of radix r,
    length n and stride s (n·s = m), input q + s·(p + k·n/r) goes into
    butterfly (p, q), and output k of that butterfly, times W_n^{kp}
    = W_m^{kps}, goes to q + s·(r·p + k).  Radices 2 and 4 are the
    kernels' butterflies; any other is a length-r DFT with W_r^{jk} =
    w_n[(jk mod r)·N/r]."""
    lead, m = z.shape[:-1], z.shape[-1]
    step = w_n.shape[0] // m
    n, s = m, 1
    for r in fft_plan(m):
        q = n // r
        x = z.reshape(*lead, r, q, s)
        p = torch.arange(q, device=z.device)
        tw = [w_n[step * k * p * s][:, None] for k in range(1, r)]
        if r == 2:
            a, b = x.unbind(-3)
            y = (a + b, (a - b) * tw[0])
        elif r == 4:
            a, b, c, d = x.unbind(-3)
            apc, amc, bpd, jbmd = a + c, a - c, b + d, 1j * (b - d)
            y = (apc + bpd, (amc - jbmd) * tw[0], (apc - bpd) * tw[1],
                 (amc + jbmd) * tw[2])
        else:
            j = torch.arange(r, device=z.device)
            dft = w_n[(j[:, None] * j) % r * (step * m // r)]    # [k, j]
            y = torch.einsum("kj,...jqs->...kqs", dft, x).unbind(-3)
            y = (y[0], *(yk * t for yk, t in zip(y[1:], tw)))
        z = torch.stack(y, dim=-2).reshape(*lead, m)
        n, s = q, s * r
    return z


def log_mel_fft_reference(y: torch.Tensor, cfg: MelSpectrogramConfig
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) float32 waveform → (log-mel (B, n_mels, F), energy (B, F)),
    float32, by the FFT kernels' schedule (``fft`` and ``mixed`` routes):
    the window, the radix stages of :func:`fft_plan` with the kernels'
    tables, then for an even n_fft the split step and for an odd one the
    first n_fft//2 + 1 bins; power, magnitude, energy and the sparse mel
    sums in float64; the mel value rounded to float32, then
    ``log(max(·, clip))`` in float32."""
    check_n_fft(cfg.n_fft)
    window, twiddles, ranges, weights = _tables_on(cfg, y.device)
    n = cfg.n_fft
    w_n = torch.complex(twiddles[:, 0], twiddles[:, 1])
    frames = frame_signal(y.double(), n, cfg.hop_length) * window
    if n % 2:
        spec = _stockham_fft(frames.to(torch.complex128), w_n)[
            ..., :n // 2 + 1]
    else:
        m = n // 2
        z = _stockham_fft(torch.complex(frames[..., 0::2], frames[..., 1::2]),
                          w_n)
        k = torch.arange(m + 1, device=y.device)
        zk = z[..., k % m]
        zc = z[..., (m - k) % m].conj()
        spec = 0.5 * (zk + zc) - 0.5j * (zk - zc) * w_n[k]
    power = spec.real ** 2 + spec.imag ** 2                  # (B, F, bins)
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
    kernel of :func:`log_mel_route`: y contiguous float32, S > n_fft/2.  No
    gradient flows through the kernels."""
    if y.device.type == "cpu":
        return mel_spectrogram(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"fused_log_mel: unsupported device {y.device}")
    if y.ndim != 2 or y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("fused_log_mel: y must be contiguous (B, S) "
                         f"float32, got {tuple(y.shape)} {y.dtype}")
    B, S = y.shape
    route = log_mel_route(cfg.n_fft)
    if S <= cfg.n_fft // 2:
        raise ValueError(f"fused_log_mel: n_fft/2 = {cfg.n_fft // 2} must "
                         f"be below S = {S} (reflect padding)")
    lib = _build.load("log_mel", _SIGNATURES)
    F = num_frames(S, cfg)
    window, twiddles, ranges, weights = _tables_on(cfg, y.device)
    mel = torch.empty((B, cfg.n_mels, F), dtype=torch.float32,
                      device=y.device)
    energy = torch.empty((B, F), dtype=torch.float32, device=y.device)
    args = [y.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
            ranges.data_ptr(), weights.data_ptr(), mel.data_ptr(),
            energy.data_ptr()]
    if route == "mixed":
        plan = fft_plan(cfg.n_fft if cfg.n_fft % 2 else cfg.n_fft // 2)
        args += [(ctypes.c_int * len(plan))(*plan), len(plan)]
    launch = {"fft": lib.log_mel_forward, "mixed": lib.log_mel_mixed_forward,
              "dft": lib.log_mel_dft_forward}[route]
    with torch.cuda.device(y.device):
        status = launch(*args, B, S, F, cfg.n_fft, cfg.hop_length,
                        cfg.n_mels, float(cfg.compression_clip),
                        torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError("fused_log_mel: launch failed: "
                           + lib.log_mel_error_string(status).decode())
    counter = {"fft": "launches", "mixed": "mixed_launches",
               "dft": "dft_launches"}[route]
    setattr(fused_log_mel, counter, getattr(fused_log_mel, counter) + 1)
    return mel, energy


fused_log_mel.launches = 0
fused_log_mel.mixed_launches = 0
fused_log_mel.dft_launches = 0
