"""Streaming (chunked) vocoding: waveform in fixed-size chunks, each from
one window of ``chunk + 2·halo`` mel frames.

The port of ``smart_nar_fast_tts_tpu/vocoder/streaming.py``.  The halo is
the generator's exact one-sided receptive field in mel frames
(:func:`mel_receptive_halo`), so every kept sample lies at least ``halo``
frames from an interior window edge, and the first and last windows sit
flush with the sequence's ends, where their zero conv padding is the full
forward's: the concatenated chunks are the full forward's samples, up to
the summation order of another shape.  Time to first audio is one window's
forward; activation memory is one window's, whatever the utterance's
length.  The windows run as module calls under ``torch.inference_mode()`` on
the generator's device.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np
import torch


def _resblock_radius(kernel: int, dilations: Sequence[int],
                     resblock: str) -> int:
    """Receptive radius (in its own resolution) added by one MRF resblock:
    ResBlock1 chains conv(k, d) → conv(k, 1) per dilation d, ResBlock2 one
    conv(k, d) per d (residual adds widen nothing)."""
    if str(resblock) == "1":
        return sum(d * (kernel - 1) // 2 + (kernel - 1) // 2
                   for d in dilations)
    return sum(d * (kernel - 1) // 2 for d in dilations)


def mel_receptive_halo(config) -> int:
    """Exact one-sided receptive field of a HiFi-GAN generator, in mel
    frames.

    Walks the network backwards keeping ``r``, the one-sided radius at the
    current layer's input resolution: a conv(k, dilation d) with symmetric
    padding adds ``d·(k-1)//2``; a ConvTranspose(k, stride u, padding
    p = (k-u)//2) maps an output span of radius r around a stage center
    to input radius ``max(ceil((r+k-1-p)/u), floor((r+p)/u))``."""
    c = config
    r = 3  # conv_post, kernel 7, at waveform resolution
    for i in reversed(range(len(c.upsample_rates))):
        r += max(
            _resblock_radius(k, d, c.resblock)
            for k, d in zip(c.resblock_kernel_sizes,
                            c.resblock_dilation_sizes))
        u, k = c.upsample_rates[i], c.upsample_kernel_sizes[i]
        p = (k - u) // 2
        r = max(-(-(r + k - 1 - p) // u), (r + p) // u)
    return r + 3  # conv_pre, kernel 7


def melgan_receptive_halo(config) -> int:
    """One-sided receptive field of a MelGAN generator (``ratios``,
    ``n_residual_layers``), in mel frames: per stage, the resnet blocks'
    dilated conv3s (3^j) and a transposed conv of k = 2·ratio, stride
    ratio."""
    c = config
    r = 3  # conv_post, kernel 7, waveform resolution
    for ratio in reversed(tuple(c.ratios)):
        r += sum(3 ** j for j in range(c.n_residual_layers))
        k, u = 2 * ratio, ratio
        p = (k - u) // 2
        r = max(-(-(r + k - 1 - p) // u), (r + p) // u)
    return r + 3  # conv_pre, kernel 7


def vocos_receptive_halo(config) -> int:
    """One-sided halo of a Vocos generator (``n_layers``, ``dw_kernel``,
    ``n_fft``, ``hop``), in mel frames: the backbone's embed conv k 7 and
    depthwise convs, plus the iSTFT overlap-add margin of ``n_fft/hop``
    frames and the one-frame edge replication."""
    c = config
    backbone = (7 - 1) // 2 + c.n_layers * ((c.dw_kernel - 1) // 2)
    return backbone + -(-c.n_fft // c.hop) + 1


def receptive_halo(config) -> int:
    """The halo of a HiFi-GAN, MelGAN or Vocos config, by its fields."""
    if hasattr(config, "upsample_rates"):
        return mel_receptive_halo(config)
    if hasattr(config, "ratios"):
        return melgan_receptive_halo(config)
    if hasattr(config, "dw_kernel"):
        return vocos_receptive_halo(config)
    raise TypeError(f"unknown vocoder config {type(config).__name__}")


class StreamingVocoder:
    """Chunked mel → waveform, equal to the generator's full forward.

    ``generator`` is a built HiFi-GAN generator (e.g. from
    ``vocoder.load_hifigan``) on its device; ``chunk_frames`` mel frames of
    audio come out per chunk, each from a window of ``chunk_frames +
    2·halo`` frames (``2·halo / window`` of each window's work is the
    overlap)."""

    def __init__(self, generator: torch.nn.Module, chunk_frames: int = 64):
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        self.generator = generator.eval()
        self.halo = receptive_halo(generator.config)
        self.chunk_frames = int(chunk_frames)
        self.window_frames = self.chunk_frames + 2 * self.halo
        self.hop = generator.config.hop_length
        self.device = next(generator.parameters()).device
        self.buffered_frames_high_water = 0

    def _apply(self, mel: np.ndarray) -> np.ndarray:
        """One forward of a (T, n_mels) mel → (T·hop,) float32 on the
        host."""
        with torch.inference_mode():
            wav = self.generator(torch.from_numpy(
                np.ascontiguousarray(mel)[None]).to(self.device))
        return wav[0].float().cpu().numpy()

    def _window_starts(self, total: int):
        """(window start, keep_lo, keep_hi) per chunk of a ``total``-frame
        mel; keep_* are the frame offsets within the window whose ``·hop``
        samples are exact."""
        c, w = self.chunk_frames, self.window_frames
        for lo in range(0, total, c):
            hi = min(lo + c, total)
            start = min(max(lo - self.halo, 0), max(total - w, 0))
            yield start, lo - start, hi - start

    def synthesize_chunks(self, mel) -> Iterator[np.ndarray]:
        """Vocode a whole (T, n_mels) or (1, T, n_mels) mel in windows,
        yielding float32 chunks whose concatenation is the full forward.  A
        mel shorter than one window runs one forward at its own length
        (zero-padding the input would not be the convs' own padding)."""
        mel = np.asarray(mel, dtype=np.float32)
        if mel.ndim == 3:
            mel = mel[0]
        total = mel.shape[0]
        if total == 0:
            return
        if total < self.window_frames:
            yield self._apply(mel)
            return
        for start, keep_lo, keep_hi in self._window_starts(total):
            wav = self._apply(mel[start: start + self.window_frames])
            yield wav[keep_lo * self.hop: keep_hi * self.hop]

    def synthesize(self, mel) -> np.ndarray:
        """The whole waveform, through :meth:`synthesize_chunks`."""
        return np.concatenate(list(self.synthesize_chunks(mel)))

    def stream(self, frames: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Online mode: take (n, n_mels) mel pieces as they come and yield a
        chunk as soon as its window's right context (``halo`` frames) has
        arrived; the same samples as :meth:`synthesize` on the whole mel.
        Frames that no later window reads are dropped, so the buffer stays
        O(window) (``buffered_frames_high_water`` records its peak)."""
        buf: list[np.ndarray] = []
        base = 0      # absolute index of buf[0]'s first frame
        have = 0      # frames received
        emitted = 0   # frames whose audio has been yielded
        c, h, w = self.chunk_frames, self.halo, self.window_frames
        self.buffered_frames_high_water = 0

        def joined() -> np.ndarray:
            return buf[0] if len(buf) == 1 else np.concatenate(buf, axis=0)

        for piece in frames:
            piece = np.asarray(piece, dtype=np.float32)
            if piece.ndim == 3:
                piece = piece[0]
            if piece.shape[0] == 0:
                continue
            buf.append(piece)
            have += piece.shape[0]
            self.buffered_frames_high_water = max(
                self.buffered_frames_high_water, have - base)
            # every chunk whose window lies inside what has arrived
            while have >= emitted + c + h and have >= w:
                mel = joined()
                start = min(max(emitted - h, 0), have - w)
                wav = self._apply(mel[start - base: start - base + w])
                lo = emitted - start
                yield wav[lo * self.hop: (lo + c) * self.hop]
                emitted += c
                # every later window starts at or after tau
                tau = max(0, min(emitted - h, have - w))
                if tau > base:
                    mel = mel[tau - base:]
                    base = tau
                buf = [mel]
        if have <= emitted:
            return
        # flush the rest with the exact right boundary
        mel = joined()
        if have < w:
            # nothing was trimmed (trimming needs have >= w): base is 0
            yield self._apply(mel)[emitted * self.hop:]
            return
        for start, keep_lo, keep_hi in self._window_starts(have):
            if start + keep_hi <= emitted:
                continue
            keep_lo = max(keep_lo, emitted - start)
            wav = self._apply(mel[start - base: start - base + w])
            yield wav[keep_lo * self.hop: keep_hi * self.hop]
            emitted = start + keep_hi
