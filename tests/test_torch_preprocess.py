"""The port's corpus preprocessing against the JAX package's, on the CPU.

- ``data.textgrid.read_textgrid`` on the long and the short Praat formats
  and ``data.alignment.get_alignment`` on tiers with leading, trailing and
  interior silences: equal trees and tuples.
- F0: the numpy NCCF tracker and DIO + StoneMask bit-equal to JAX's; the
  native library (built from the same sources with the same flags) bit-equal
  to JAX's native one for the ``world`` and ``nccf`` selections; a missing
  or broken source makes the build raise, where JAX falls back to numpy.
- The mel and energy of the raw waveform against JAX's
  ``mel_spectrogram_bucketed``: mel atol 1e-4, energy rtol 1e-5.
- The whole ``Preprocessor`` on one corpus of ``benchmarks/corpus.py``'s
  scaled synthetic speech (8 utterances, 2 speakers), frame and phoneme
  level: file lists, ``.npy`` headers, ``speakers.json``, ``train.txt``
  and ``val.txt`` equal; pitch and its stats exact; mel atol 1e-4; energy
  (in its own units) and its stats rtol 1e-5.  ``num_workers=2`` against
  the serial run; ``prepare_align`` byte for byte; ``cli.preprocess`` in a
  process where JAX, flax, yaml and the JAX package cannot be imported,
  read back by the port's ``AcousticDataset``; and the device rule.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import corpus as scaled
from smart_nar_fast_tts_tpu.audio.stft import mel_spectrogram_bucketed
from smart_nar_fast_tts_tpu.config import AudioConfig as JaxAudioConfig
from smart_nar_fast_tts_tpu.config import \
    PreprocessConfig as JaxPreprocessConfig
from smart_nar_fast_tts_tpu.data import alignment as jax_alignment
from smart_nar_fast_tts_tpu.data import ljspeech as jax_ljspeech
from smart_nar_fast_tts_tpu.data import native_f0 as jax_native_f0
from smart_nar_fast_tts_tpu.data import pitch as jax_pitch
from smart_nar_fast_tts_tpu.data import textgrid as jax_textgrid
from smart_nar_fast_tts_tpu.data import world_f0 as jax_world_f0
from smart_nar_fast_tts_tpu.data.preprocessor import \
    Preprocessor as JaxPreprocessor
from smart_nar_fast_tts_tpu_torch.audio.stft import (MelSpectrogramConfig,
                                                     mel_spectrogram)
from smart_nar_fast_tts_tpu_torch.config import AudioConfig, PreprocessConfig
from smart_nar_fast_tts_tpu_torch.data import (AcousticDataset, Preprocessor,
                                               alignment, ljspeech, native_f0,
                                               pitch, textgrid, world_f0)
from smart_nar_fast_tts_tpu_torch.data.wavio import load_wav, save_wav
from torch_port_util import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, HOP = 22050, 256
MEL_ATOL = 1e-4
ENERGY_RTOL = 1e-5
N_UTTS, N_SPEAKERS, VAL_SIZE = 8, 2, 2
BLOCKED = ("jax", "flax", "yaml", "smart_nar_fast_tts_tpu")


def write_scaled_corpus(root, n_utts=N_UTTS, n_speakers=N_SPEAKERS, seed=0):
    """``benchmarks/corpus.py``'s ``make_scaled_corpus`` with the port's
    ``save_wav``: ``raw/<spk>/uttN.{wav,lab}`` and ``TextGrid/<spk>/``."""
    rng = np.random.default_rng(seed)
    speakers = {f"spk{s}": scaled.speaker_params(s, rng)
                for s in range(n_speakers)}
    for u in range(n_utts):
        name = f"spk{u % n_speakers}"
        spk_dir = root / "raw" / name
        tg_dir = root / "TextGrid" / name
        spk_dir.mkdir(parents=True, exist_ok=True)
        tg_dir.mkdir(parents=True, exist_ok=True)
        entries = scaled.sample_entries(speakers[name], rng)
        wav = scaled.synth_utterance(entries, speakers[name], rng)
        save_wav(str(spk_dir / f"utt{u:05d}.wav"), wav, scaled.SR)
        (spk_dir / f"utt{u:05d}.lab").write_text(
            f"scaled synthetic utterance {u} ({name})")
        scaled._write_textgrid(str(tg_dir / f"utt{u:05d}.TextGrid"),
                               entries, entries[-1][1])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("scaled")
    write_scaled_corpus(root)
    return root


@pytest.fixture(scope="module")
def jax_native():
    """JAX's native library, loaded.  Every test process imports
    ``tests/test_native_f0.py``, which builds it in place at import: one
    process can find another's half-written file and fall back to numpy
    for good, so the load is retried here."""
    import time
    for _ in range(5):
        if jax_native_f0.native_available():
            return jax_native_f0
        jax_native_f0._build_failed = False
        time.sleep(3)
    raise AssertionError("the JAX package's native F0 library does not load")


def run_store(pkg, corpus, out, level, workers=1, seed=1234):
    """One preprocessing run of ``pkg`` ("jax" or "port") into ``out``."""
    shutil.copytree(corpus / "TextGrid", out / "TextGrid")
    kw = dict(data_path=str(corpus / "raw"), preprocessed_path=str(out),
              val_size=VAL_SIZE, pitch_feature=level, energy_feature=level)
    if pkg == "jax":
        pre = JaxPreprocessor(JaxPreprocessConfig(audio=JaxAudioConfig(),
                                                  **kw))
    else:
        pre = Preprocessor(PreprocessConfig(audio=AudioConfig(), **kw),
                           device="cpu")
    return pre.build_from_path(seed=seed, num_workers=workers)


@pytest.fixture(scope="module")
def stores(corpus, jax_native, tmp_path_factory):
    """Both packages' stores of the corpus at each feature level."""
    out = {}
    for level in ("frame_level", "phoneme_level"):
        for pkg in ("jax", "port"):
            path = tmp_path_factory.mktemp(f"{pkg}_{level}")
            run_store(pkg, corpus, path, level)
            out[pkg, level] = path
    return out


def npy_header(path):
    """(shape, fortran order, dtype) of a ``.npy`` file."""
    fmt = np.lib.format
    with open(path, "rb") as f:
        version = fmt.read_magic(f)
        return (fmt.read_array_header_1_0 if version == (1, 0)
                else fmt.read_array_header_2_0)(f)


def compare_stores(a, b, mel_atol=MEL_ATOL, energy_rtol=ENERGY_RTOL):
    """Gates two stores against each other; returns the max errors."""
    kinds = ("mel", "pitch", "energy")
    for kind in kinds:
        assert sorted(os.listdir(a / kind)) == sorted(os.listdir(b / kind))
    for name in ("speakers.json", "train.txt", "val.txt"):
        assert (a / name).read_text() == (b / name).read_text(), name
    sa = json.loads((a / "stats.json").read_text())
    sb = json.loads((b / "stats.json").read_text())
    assert sa["pitch"] == sb["pitch"]
    np.testing.assert_allclose(sa["energy"], sb["energy"], rtol=energy_rtol)
    errs = {"mel": 0.0, "energy_rel": 0.0}
    for kind in kinds:
        for name in sorted(os.listdir(a / kind)):
            assert npy_header(a / kind / name) == npy_header(b / kind / name)
            x, y = np.load(a / kind / name), np.load(b / kind / name)
            if kind == "pitch":
                np.testing.assert_array_equal(x, y)
            elif kind == "mel":
                np.testing.assert_allclose(x, y, rtol=0, atol=mel_atol)
                errs["mel"] = max(errs["mel"], float(np.abs(x - y).max()))
            else:              # in energy's own units: z · std + mean
                xe = x * sa["energy"][3] + sa["energy"][2]
                ye = y * sb["energy"][3] + sb["energy"][2]
                np.testing.assert_allclose(xe, ye, rtol=energy_rtol)
                errs["energy_rel"] = max(errs["energy_rel"], float(
                    (np.abs(xe - ye) / np.abs(ye)).max()))
    return errs


# ---------------------------------------------------------------------------
# TextGrids and alignment
# ---------------------------------------------------------------------------

ENTRIES = [(0.0, 0.07, "sil"), (0.07, 0.21, "AA1"), (0.21, 0.3, "sp"),
           (0.3, 0.41, "S"), (0.41, 0.55, 'say ""hi"" now'), (0.55, 0.62, "sil")]


def short_textgrid(entries):
    total = entries[-1][1]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "0", str(total), "<exists>", "2", '"IntervalTier"',
             '"phones"', "0", str(total), str(len(entries))]
    for s, e, p in entries:
        lines += [str(s), str(e), f'"{p}"']
    lines += ['"TextTier"', '"marks"', "0", str(total), "1", "0.3",
              '"mark"']
    return "\n".join(lines) + "\n"


def tree(tg):
    return [(t.name, [(iv.start_time, iv.end_time, iv.text)
                      for iv in t.intervals]) for t in tg.tiers]


@pytest.mark.parametrize("fmt", ["long", "short"])
def test_read_textgrid(tmp_path, fmt):
    path = str(tmp_path / "x.TextGrid")
    if fmt == "long":
        scaled._write_textgrid(path, ENTRIES, ENTRIES[-1][1])
    else:
        (tmp_path / "x.TextGrid").write_text(short_textgrid(ENTRIES))
    got, want = textgrid.read_textgrid(path), jax_textgrid.read_textgrid(path)
    assert tree(got) == tree(want)
    assert tree(got)[0] == ("phones", [(s, e, p.replace('""', '"'))
                                       for s, e, p in ENTRIES])
    assert got.get_tier_by_name("phones")._objects \
        == got.tiers[0].intervals


@pytest.mark.parametrize("case", ["silences", "all_silence", "no_silence",
                                  "scaled"])
def test_get_alignment(case):
    entries = {
        "silences": ENTRIES[:4] + [(0.41, 0.55, "T"), (0.55, 0.6, "spn"),
                                   (0.6, 0.7, "sp")],
        "all_silence": [(0.0, 0.3, "sil"), (0.3, 0.5, "sp")],
        "no_silence": [(0.0, 0.1234, "K"), (0.1234, 0.3, "IY1")],
        "scaled": scaled.sample_entries(
            scaled.speaker_params(0, np.random.default_rng(5)),
            np.random.default_rng(6)),
    }[case]
    tier = textgrid.Tier("phones", [textgrid.Interval(*e) for e in entries])
    jax_tier = jax_textgrid.Tier(
        "phones", [jax_textgrid.Interval(*e) for e in entries])
    got = alignment.get_alignment(tier, SR, HOP)
    assert got == jax_alignment.get_alignment(jax_tier, SR, HOP)
    assert all(isinstance(d, int) for d in got[1])


# ---------------------------------------------------------------------------
# F0
# ---------------------------------------------------------------------------

def f0_signal(seed):
    """Gliding harmonics, a silent third, a noise floor (float32, as the
    preprocessor's waveforms)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * 0.9)) / SR
    f = 140.0 + 60.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f) / SR
    wav = 0.6 * np.sin(phase) + 0.25 * np.sin(2 * phase)
    wav[len(wav) // 3:2 * len(wav) // 3] = 0.0
    return (wav + 0.005 * rng.standard_normal(len(wav))).astype(np.float32)


@pytest.mark.parametrize("tracker", ["nccf", "world"])
def test_numpy_f0_bit_equal(tracker):
    wav = f0_signal(1)
    if tracker == "nccf":
        got, want = (pitch.estimate_f0(wav, SR, HOP),
                     jax_pitch.estimate_f0(wav, SR, HOP))
    else:
        got, want = (world_f0.estimate_f0_world(wav, SR, HOP),
                     jax_world_f0.estimate_f0_world(wav, SR, HOP))
    assert (got > 0).sum() > len(got) // 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tracker", ["world", "nccf"])
def test_native_f0_bit_equal(jax_native, monkeypatch, tracker):
    monkeypatch.setenv("SMART_TTS_F0", tracker)
    for seed in (2, 3):
        wav = f0_signal(seed)
        got = native_f0.estimate_f0_native(wav, SR, HOP)
        want = jax_native.estimate_f0_native(wav, SR, HOP)
        assert (got > 0).sum() > len(got) // 3
        np.testing.assert_array_equal(got, want)


def test_native_off_runs_numpy(monkeypatch):
    monkeypatch.setenv("SMART_TTS_NATIVE_F0", "off")
    monkeypatch.setattr(native_f0, "load", None)   # never reached
    wav = f0_signal(4)
    np.testing.assert_array_equal(native_f0.estimate_f0_native(wav, SR, HOP),
                                  world_f0.estimate_f0_world(wav, SR, HOP))
    monkeypatch.setenv("SMART_TTS_F0", "nccf")
    np.testing.assert_array_equal(native_f0.estimate_f0_native(wav, SR, HOP),
                                  pitch.estimate_f0(wav, SR, HOP))


@pytest.mark.parametrize("fault", ["missing", "broken"])
def test_native_build_raises(tmp_path, monkeypatch, fault):
    """Where JAX silently runs numpy, the port raises, with g++'s output."""
    sources = [tmp_path / "f0.cc", tmp_path / "world_f0.cc"]
    for src, orig in zip(sources, native_f0.SOURCES):
        shutil.copy(orig, src)
    if fault == "missing":
        sources[1].unlink()
        expect, match = FileNotFoundError, "world_f0.cc"
    else:
        with open(sources[1], "a") as f:
            f.write("\nint smart_broken( {\n")
        expect, match = RuntimeError, "error"
    monkeypatch.setattr(native_f0, "SOURCES", tuple(sources))
    monkeypatch.setattr(native_f0, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(expect, match=match):
        native_f0.estimate_f0_native(f0_signal(5), SR, HOP)
    assert not native_f0.native_available()
    assert not list((tmp_path / "build").glob("*/*.so"))


# ---------------------------------------------------------------------------
# mel features and the store
# ---------------------------------------------------------------------------

def test_mel_matches_bucketed(corpus):
    """The port's mel of the raw (1, T) waveform against JAX's bucketed
    lowering, on each utterance's cut as the preprocessor cuts it."""
    cfg = MelSpectrogramConfig()
    mel_err = energy_err = 0.0
    for wav_path in sorted((corpus / "raw").glob("*/*.wav"))[:6]:
        wav, _ = load_wav(str(wav_path), SR)
        wav = wav[int(0.05 * SR):len(wav) - int(0.04 * SR)]
        with torch.no_grad():
            mel, energy = mel_spectrogram(torch.from_numpy(wav)[None], cfg)
        jmel, jenergy = mel_spectrogram_bucketed(wav, cfg)
        assert mel.shape[1:] == jmel.shape and energy.shape[1:] \
            == jenergy.shape == (len(wav) // HOP + 1,)
        np.testing.assert_allclose(mel[0].numpy(), jmel, rtol=0,
                                   atol=MEL_ATOL)
        np.testing.assert_allclose(energy[0].numpy(), jenergy,
                                   rtol=ENERGY_RTOL)
        mel_err = max(mel_err, float(np.abs(mel[0].numpy() - jmel).max()))
        energy_err = max(energy_err, float(
            (np.abs(energy[0].numpy() - jenergy) / jenergy).max()))
    print(f"mel max abs err {mel_err:.3g}, energy max rel err "
          f"{energy_err:.3g}")


@pytest.mark.parametrize("level", ["frame_level", "phoneme_level"])
def test_store_matches_jax(stores, level):
    jax_store, port_store = stores["jax", level], stores["port", level]
    n_mel = len(os.listdir(port_store / "mel"))
    assert n_mel == N_UTTS
    assert len((port_store / "val.txt").read_text().splitlines()) \
        == VAL_SIZE
    errs = compare_stores(port_store, jax_store)
    print(level, errs)
    name = sorted(os.listdir(port_store / "mel"))[0]
    mel = np.load(port_store / "mel" / name)
    p = np.load(port_store / "pitch" / name.replace("-mel-", "-pitch-"))
    assert mel.shape[1] == 80 and mel.dtype == np.float32
    if level == "frame_level":
        assert len(p) == mel.shape[0]
    else:
        assert len(p) < mel.shape[0]


def test_parallel_matches_serial(corpus, stores, tmp_path):
    """Two spawn workers on the CPU write the serial run's store."""
    run_store("port", corpus, tmp_path, "frame_level", workers=2)
    serial = stores["port", "frame_level"]
    compare_stores(tmp_path, serial)
    sa = json.loads((tmp_path / "stats.json").read_text())
    sb = json.loads((serial / "stats.json").read_text())
    for kind in ("pitch", "energy"):
        np.testing.assert_allclose(sa[kind], sb[kind], rtol=1e-9)


def test_prepare_align(tmp_path):
    """metadata.csv → cleaned .lab and peak-normalised .wav: the same text
    and the same bytes as JAX's, a 16 kHz source resampled, a line without
    its wav skipped."""
    src = tmp_path / "LJSpeech-1.1"
    (src / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(7)
    rows = [("LJ001-0001", "Mr. Smith paid $5 on Jan. 3rd, 1999!", 22050),
            ("LJ001-0002", "Dr. Who?  It's   2 o'clock.", 16000),
            ("LJ001-0003", "No wav for this line.", None)]
    for name, text, sr in rows:
        if sr is not None:
            wav = 0.3 * np.sin(np.arange(sr // 2) * 0.05) \
                + 0.01 * rng.standard_normal(sr // 2)
            save_wav(str(src / "wavs" / f"{name}.wav"),
                     wav.astype(np.float32), sr)
    (src / "metadata.csv").write_text(
        "".join(f"{n}|{t}|{t}\n" for n, t, _ in rows), encoding="utf-8")
    outs = {}
    for pkg in ("jax", "port"):
        data = tmp_path / pkg
        if pkg == "jax":
            cfg = JaxPreprocessConfig(data_path=str(data))
            n = jax_ljspeech.prepare_align(str(src), cfg)
        else:
            cfg = PreprocessConfig(data_path=str(data))
            n = ljspeech.prepare_align(str(src), cfg)
        assert n == 2
        outs[pkg] = data / "LJSpeech"
    names = sorted(os.listdir(outs["port"]))
    assert names == sorted(os.listdir(outs["jax"])) and len(names) == 4
    for name in names:
        assert (outs["port"] / name).read_bytes() \
            == (outs["jax"] / name).read_bytes(), name
    assert (outs["port"] / "LJ001-0001.lab").read_text() \
        == "mister smith paid five dollars on jan. third, nineteen " \
           "ninety-nine!"


def test_cli_preprocess(corpus, stores, tmp_path):
    """``python -m smart_nar_fast_tts_tpu_torch.cli.preprocess`` where JAX,
    flax, yaml and the JAX package cannot be imported, on a YAML file;
    then the port's ``AcousticDataset`` reads the store."""
    out = tmp_path / "preprocessed"
    shutil.copytree(corpus / "TextGrid", out / "TextGrid")
    cfg_path = tmp_path / "preprocess.yaml"
    cfg_path.write_text(
        'dataset: "Scaled"\npath:\n  lexicon_path: ""\n'
        f'  data_path: "{corpus / "raw"}"\n'
        f'  preprocessed_path: "{out}"\n'
        f"preprocessing:\n  val_size: {VAL_SIZE}\n"
        '  pitch:\n    feature: "frame_level"\n    normalization: True\n')
    code = (f"import runpy, sys\nfor n in {BLOCKED!r}:\n"
            "    sys.modules[n] = None\n"
            f"sys.argv = ['preprocess', {str(cfg_path)!r}, '--device', "
            "'cpu']\nrunpy.run_module('smart_nar_fast_tts_tpu_torch.cli."
            "preprocess', run_name='__main__', alter_sys=True)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] \
        == f"preprocessed {N_UTTS} utterances → {out}"
    serial = stores["port", "frame_level"]
    compare_stores(out, serial)

    cfg = PreprocessConfig(preprocessed_path=str(out))
    for split, n in (("train.txt", N_UTTS - VAL_SIZE), ("val.txt",
                                                        VAL_SIZE)):
        ds = AcousticDataset(split, cfg)
        assert len(ds) == n
        for i in range(n):
            item = ds[i]
            assert len(item["text"]) > 0
            assert item["mel"].shape[0] == len(item["pitch"]) \
                == len(item["energy"])


def test_device_rule(monkeypatch):
    """With no card, the default device raises: no fall back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Preprocessor(PreprocessConfig())
    assert Preprocessor(PreprocessConfig(), device="cpu").device \
        == torch.device("cpu")
