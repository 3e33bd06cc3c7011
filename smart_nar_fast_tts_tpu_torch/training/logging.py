"""Metrics and figures: TensorBoard event files, mel figures, audio clips and
the plain-text log, as ``smart_nar_fast_tts_tpu/training/logging.py``
(reference ``utils/tools.py:64-86`` ``log``, ``:202-251`` ``plot_mel``,
``train.py:48-56`` and ``:97-109``), without ``tensorboard`` or
``matplotlib``, which the card's machine lacks.

- ``MetricWriter`` writes the event file itself: TFRecord framing (a
  little-endian 64-bit length, the masked CRC32C of those 8 bytes, the
  data, the masked CRC32C of the data) around ``Event`` protobufs encoded
  by hand (``tensorflow/core/util/event.proto``, ``summary.proto``): the
  ``file_version`` event first, then scalar ``simple_value``, PNG
  ``image`` and WAV ``audio`` summaries.  TensorBoard reads them as it
  reads ``torch.utils.tensorboard``'s.
- ``plot_mel`` draws the stacked panels as an RGB array: each mel as a heat
  map, one pixel per (frame, channel), with the de-normalised pitch and
  energy as 1-pixel curves in the JAX figure's colours, each scaled to the
  panel's height.  It draws no glyphs (titles, axes, labels): the summary's
  tag names the figure.
- ``save_mel_png`` writes a mel as a PNG heat map for the synthesize CLI;
  the PNG writer is a small one on ``zlib`` and ``struct``.
"""

from __future__ import annotations

import io
import itertools
import os
import socket
import struct
import time
import wave
import zlib
from typing import Optional

import numpy as np

from ..config import FeatureStats
from ..parallel.mesh import world

# anchors of a viridis-like ramp, dark (low) to light (high), RGB
_RAMP = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                  [94, 201, 98], [253, 231, 37]], np.float64)
# the JAX figure's overlay colours (matplotlib "tomato", "darkviolet")
PITCH_RGB = (255, 99, 71)
ENERGY_RGB = (148, 0, 211)
# white rows between stacked panels
PANEL_GAP = 4
# the event files' last name field: writers opened in one second by one
# process (a resumed run) get files of their own
_WRITER_IDS = itertools.count()


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


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → an 8-bit RGB PNG, rows top to bottom, filter type
    0 on every row."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def save_mel_png(path: str, mel: np.ndarray) -> None:
    """A mel (n_mels, T) as a PNG heat map of T × n_mels pixels, channel 0
    in the bottom row."""
    write_png(path, colorize(np.asarray(mel)[::-1]))


def encode_wav(wav: np.ndarray, sampling_rate: int) -> bytes:
    """Mono float samples in [-1, 1] → a 16-bit PCM WAV file's bytes."""
    pcm = np.clip(np.asarray(wav, np.float64) * 32767.0, -32767, 32767)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sampling_rate))
        w.writeframes(pcm.astype("<i2").tobytes())
    return buf.getvalue()


# -- TFRecord framing and the Event protobuf ------------------------------

def _crc32c_table() -> np.ndarray:
    poly = 0x82F63B78                     # Castagnoli, reflected
    crc = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ np.uint32(poly), crc >> 1)
    return crc.astype(np.uint32)


_CRC32C = [int(v) for v in _crc32c_table()]


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        low = n & 0x7F
        n >>= 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _int(field: int, n: int) -> bytes:
    return _key(field, 0) + _varint(n)


def _event(step: int, summary: Optional[bytes] = None,
           file_version: Optional[str] = None) -> bytes:
    """``Event``: wall_time (1, double), step (2, int64), file_version (3,
    string) or summary (5, ``Summary``)."""
    out = _key(1, 1) + struct.pack("<d", time.time()) + _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if summary is not None:
        out += _bytes(5, summary)
    return out


def _value(tag: str, body: bytes) -> bytes:
    """``Summary`` holding one ``Summary.Value``: tag (1) and ``body``, the
    value's oneof field already encoded."""
    return _bytes(1, _bytes(1, tag.encode()) + body)


def scalar_summary(tag: str, value: float) -> bytes:
    return _value(tag, _key(2, 5) + struct.pack("<f", value))


def image_summary(tag: str, rgb: np.ndarray) -> bytes:
    """``Summary.Image`` (4): height (1), width (2), colorspace (3, 3 =
    RGB), encoded_image_string (4, PNG)."""
    h, w, _ = rgb.shape
    image = (_int(1, h) + _int(2, w) + _int(3, 3)
             + _bytes(4, encode_png(rgb)))
    return _value(tag, _bytes(4, image))


def audio_summary(tag: str, wav: np.ndarray, sampling_rate: int) -> bytes:
    """``Summary.Audio`` (6): sample_rate (1, float), num_channels (2),
    length_frames (3), encoded_audio_string (4, WAV), content_type (5)."""
    audio = (_key(1, 5) + struct.pack("<f", float(sampling_rate))
             + _int(2, 1) + _int(3, len(wav))
             + _bytes(4, encode_wav(wav, sampling_rate))
             + _bytes(5, b"audio/wav"))
    return _value(tag, _bytes(6, audio))


class MetricWriter:
    """TensorBoard event file + append-only text log under ``log_dir``;
    no-ops on every rank but the first (the JAX writer's "only the primary
    process writes")."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.enabled = world()[0] == 0
        self._file = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.{next(_WRITER_IDS)}")
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "wb")
        self._write(_event(0, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        if self._file is None:
            return
        self._file.write(tfrecord(event))
        self._file.flush()

    def _summary(self, step: int, summary: bytes) -> None:
        self._write(_event(step, summary=summary))

    def scalars(self, step: int, losses) -> None:
        """LossBreakdown → the reference's 7 scalar tags
        (``utils/tools.py:66-76``)."""
        names = ("total_loss", "mel_loss", "mel_postnet_loss", "pitch_loss",
                 "energy_loss", "duration_loss", "attn_loss")
        values = (losses.total, losses.mel, losses.postnet_mel, losses.pitch,
                  losses.energy, losses.duration, losses.attention)
        for name, value in zip(names, values):
            self.scalar(step, f"Loss/{name}", value)

    def scalar(self, step: int, tag: str, value: float) -> None:
        self._summary(step, scalar_summary(tag, float(value)))

    def scalar_dict(self, step: int, values: dict, prefix: str = "Perf"
                    ) -> None:
        for tag, value in values.items():
            self.scalar(step, f"{prefix}/{tag}", value)

    def figure(self, step: int, tag: str, rgb: np.ndarray) -> None:
        """An (H, W, 3) uint8 figure (:func:`plot_mel`) as a PNG image."""
        self._summary(step, image_summary(tag, rgb))

    def audio(self, step: int, tag: str, wav: np.ndarray,
              sampling_rate: int) -> None:
        """A clip normalised by its peak, as the JAX writer's."""
        wav = np.asarray(wav, np.float32)
        peak = float(np.max(np.abs(wav))) or 1.0
        self._summary(step, audio_summary(tag, wav / peak, sampling_rate))

    def message(self, text: str, filename: str = "log.txt") -> None:
        """Append-only text log (reference ``train.py:104-108``)."""
        if not self.enabled:
            return
        with open(os.path.join(self.log_dir, filename), "a") as f:
            f.write(text + "\n")

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def format_losses(step: int, total_step: int, losses) -> str:
    """The reference's two-line progress message (``train.py:97-103``)."""
    return (
        f"Step {step}/{total_step}, "
        "Total Loss: {:.4f}, Mel Loss: {:.4f}, Mel PostNet Loss: {:.4f}, "
        "Pitch Loss: {:.4f}, Energy Loss: {:.4f}, Duration Loss: {:.4f}, "
        "Attn Loss: {:.4f}".format(
            float(losses.total), float(losses.mel),
            float(losses.postnet_mel), float(losses.pitch),
            float(losses.energy), float(losses.duration),
            float(losses.attention)))


def _curve(panel: np.ndarray, values: np.ndarray, rgb) -> None:
    """Draw ``values`` (one per column) into ``panel`` (H, W, 3) as a
    1-pixel curve scaled to the panel's height (a twin axis's autoscale),
    consecutive points joined by vertical runs."""
    h, w, _ = panel.shape
    v = np.asarray(values, np.float64)[:w]
    lo, hi = float(v.min()), float(v.max())
    x = (v - lo) / (hi - lo) if hi > lo else np.full_like(v, 0.5)
    rows = (h - 1) - np.rint(x * (h - 1)).astype(np.int64)
    for col, row in enumerate(rows):
        prev = rows[col - 1] if col else row
        a, b = min(prev, row), max(prev, row)
        panel[a:b + 1, col] = rgb


def plot_mel(data, stats: Optional[FeatureStats]) -> np.ndarray:
    """Stacked mel panels with pitch/energy overlays (reference
    ``utils/tools.py:202-251``) as an (H, W, 3) uint8 image.

    data: list of (mel (n_mels, T), pitch (T,), energy (T,)) tuples; pitch
    and energy are de-normalised with the corpus stats when given.  Each
    panel is n_mels rows (channel 0 at the bottom) by T columns; panels are
    stacked top to bottom, PANEL_GAP white rows apart, as wide as the
    widest.
    """
    panels = []
    for mel, pitch, energy in data:
        panel = colorize(np.asarray(mel)[::-1])
        if pitch is not None:
            if stats is not None:
                pitch = pitch * stats.pitch_std + stats.pitch_mean
            _curve(panel, pitch, PITCH_RGB)
        if energy is not None:
            if stats is not None:
                energy = energy * stats.energy_std + stats.energy_mean
            _curve(panel, energy, ENERGY_RGB)
        panels.append(panel)
    width = max(p.shape[1] for p in panels)
    rows = []
    for i, panel in enumerate(panels):
        if i:
            rows.append(np.full((PANEL_GAP, width, 3), 255, np.uint8))
        pad = np.full((panel.shape[0], width - panel.shape[1], 3), 255,
                      np.uint8)
        rows.append(np.concatenate([panel, pad], axis=1))
    return np.concatenate(rows, axis=0)
