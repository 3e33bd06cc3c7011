"""The port's training observability, without tensorboard or matplotlib.

- ``training.logging``: CRC32C of ``b"123456789"`` is 0xE3069283 (the
  check value of the Castagnoli CRC); a ``MetricWriter``'s event file,
  read by TensorBoard's ``event_accumulator``, holds the scalars, the
  ``Loss/*`` tags, the image summary (its PNG decodes to the figure
  written) and the audio summary (its WAV decodes to the clip normalised by
  its peak, in 16-bit PCM); every record's two CRCs check; the text log.
- ``plot_mel``: stacked panels as wide as the widest, the mel heat map
  with the pitch and energy curves in their colours, one pixel a frame.
- ``training.profiling``: the profiler's window traces the steps after
  ``start_step`` into a Chrome trace under ``<log_dir>/profile``;
  ``Throughput``'s rates.
"""

import io
import json
import os
import struct
import wave
import zlib

import numpy as np
import torch
from tensorboard.backend.event_processing import event_accumulator

from smart_nar_fast_tts_tpu_torch.config import FeatureStats
from smart_nar_fast_tts_tpu_torch.models.loss import LossBreakdown
from smart_nar_fast_tts_tpu_torch.training import logging as tlog
from smart_nar_fast_tts_tpu_torch.training.profiling import (StepProfiler,
                                                             Throughput)


def test_crc32c_check_value():
    assert tlog.crc32c(b"123456789") == 0xE3069283
    assert tlog.crc32c(b"") == 0


def _decode_png(data):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    return rows.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def _records(path):
    """Each TFRecord's data, both CRCs checked."""
    with open(path, "rb") as f:
        data = f.read()
    pos, out = 0, []
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        assert crc == tlog.masked_crc32c(header)
        body = data[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        assert crc == tlog.masked_crc32c(body)
        out.append(body)
        pos += 16 + n
    return out


def test_event_file_reads_back(tmp_path):
    rng = np.random.default_rng(0)
    fig = rng.integers(0, 256, (20, 31, 3), dtype=np.uint8)
    clip = (0.3 * np.sin(np.arange(800) / 7.0)).astype(np.float32)
    writer = tlog.MetricWriter(str(tmp_path))
    writer.scalars(3, LossBreakdown(*[float(i) + 0.5 for i in range(7)]))
    writer.scalar_dict(4, {"steps_per_sec": 2.25})
    writer.figure(5, "Training/step_5_utt0", fig)
    writer.audio(5, "Training/step_5_utt0_synthesized", clip, 22050)
    writer.message("line one")
    writer.message("line two")
    writer.close()

    names = os.listdir(tmp_path)
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    assert len(events) == 1 and "log.txt" in names
    assert len(_records(tmp_path / events[0])) == 1 + 7 + 1 + 1 + 1
    with open(tmp_path / "log.txt") as f:
        assert f.read() == "line one\nline two\n"

    acc = event_accumulator.EventAccumulator(
        str(tmp_path), size_guidance={"scalars": 0, "images": 0,
                                      "audio": 0})
    acc.Reload()
    tags = acc.Tags()
    assert tags["scalars"] == [
        "Loss/total_loss", "Loss/mel_loss", "Loss/mel_postnet_loss",
        "Loss/pitch_loss", "Loss/energy_loss", "Loss/duration_loss",
        "Loss/attn_loss", "Perf/steps_per_sec"]
    assert [(e.step, e.value) for e in acc.Scalars("Loss/attn_loss")] == [
        (3, 6.5)]
    assert [(e.step, e.value) for e in acc.Scalars(
        "Perf/steps_per_sec")] == [(4, 2.25)]
    (img,) = acc.Images("Training/step_5_utt0")
    assert (img.step, img.width, img.height) == (5, 31, 20)
    np.testing.assert_array_equal(_decode_png(img.encoded_image_string),
                                  fig)
    (aud,) = acc.Audio("Training/step_5_utt0_synthesized")
    assert (aud.step, aud.sample_rate, aud.length_frames) == (5, 22050, 800)
    assert aud.content_type == "audio/wav"
    with wave.open(io.BytesIO(aud.encoded_audio_string)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (
            1, 2, 22050)
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    peak = np.abs(clip).max()
    expect = (clip / peak).astype(np.float64) * 32767.0      # f32 division
    np.testing.assert_array_equal(pcm, expect.astype(np.int16))


def test_resumed_writer_appends(tmp_path):
    """A second writer on the same directory (a resumed run) appends to
    ``log.txt`` and starts an event file of its own."""
    log_dir = str(tmp_path / "train")
    paths = []
    for step, text in ((2, "first"), (4, "second")):
        writer = tlog.MetricWriter(log_dir)
        writer.scalar(step, "x", float(step))
        writer.message(text)
        writer.close()
        paths.append(writer.path)
    assert len(set(paths)) == 2 and all(map(os.path.exists, paths))
    with open(os.path.join(log_dir, "log.txt")) as f:
        assert f.read() == "first\nsecond\n"
    for path, step in zip(paths, (2, 4)):
        acc = event_accumulator.EventAccumulator(path)
        acc.Reload()
        assert [(e.step, e.value) for e in acc.Scalars("x")] == [
            (step, float(step))]


def test_plot_mel():
    mel = np.linspace(-5.0, 0.0, 8 * 12, dtype=np.float32).reshape(8, 12)
    pitch = np.linspace(-1.0, 1.0, 12, dtype=np.float32)       # rises
    energy = np.full(12, 0.3, np.float32)                      # flat
    stats = FeatureStats(pitch_mean=100.0, pitch_std=20.0,
                         energy_mean=5.0, energy_std=2.0)
    img = tlog.plot_mel([(mel, pitch, energy), (mel[:, :9], None, None)],
                        stats)
    assert img.shape == (8 + tlog.PANEL_GAP + 8, 12, 3)
    top = img[:8]
    # the pitch curve runs from the bottom row to the top one; the energy
    # curve (constant) sits in the middle row and is drawn last
    assert tuple(top[7, 0]) == tlog.PITCH_RGB
    assert tuple(top[0, 11]) == tlog.PITCH_RGB
    assert all(tuple(top[3, c]) == tlog.ENERGY_RGB for c in range(12))
    gap = img[8:8 + tlog.PANEL_GAP]
    assert (gap == 255).all()
    bottom = img[8 + tlog.PANEL_GAP:]
    np.testing.assert_array_equal(bottom[:, :9],
                                  tlog.colorize(mel[:, :9][::-1]))
    assert (bottom[:, 9:] == 255).all()


def test_step_profiler_window(tmp_path):
    prof = StepProfiler(str(tmp_path), start_step=2, num_steps=2)
    x = torch.ones(64, 64)
    for step in range(1, 7):
        x = torch.tanh(x @ x)
        prof.step(step)
    prof.close()
    assert prof.trace_path == str(tmp_path / "profile" /
                                  "trace_steps_3-4.json")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and "aten::tanh" in names
    off = StepProfiler(str(tmp_path / "off"), start_step=0)
    off.step(1)
    off.close()
    assert off.trace_path is None


def test_throughput():
    t = Throughput()
    assert t.snapshot() is None
    t.update(100)                      # the first update starts the clock
    assert t.snapshot() is None
    t.update(200)
    t.update(300)
    rates = t.snapshot()
    assert set(rates) == {"steps_per_sec", "mel_frames_per_sec_per_chip"}
    assert np.isclose(rates["mel_frames_per_sec_per_chip"]
                      / rates["steps_per_sec"], 250.0)
    assert t.snapshot() is None
