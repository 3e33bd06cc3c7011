"""The port's exported serving artifacts (``serving.export_serving_artifacts``,
``serving.ExportedTTS``) against the JAX package's, on the CPU.

One module fixture exports the tiny model of ``tests/test_serving_export.py``
(its weights seeded as an init gives them, durations biased to ~11 frames a
phoneme so that a 16-phoneme text escalates past the small frame capacity)
and a tiny HiFi-GAN, both with the same weights as their JAX twins, to two
text buckets, two frame capacities, three vocoder buckets and a 16-frame
streaming window.  Checked: the manifest's keys and files against the JAX
export's (its ``jax.export`` calls stubbed out: only the layout is
compared); the weights stored once (no ``.pt2`` holds tensor data); each
program calling the registered upsampling operator once (the flash one at
a capacity past 2048 frames); the exported outputs equal to the port's live
model (exact, the same device) and to the JAX live model (mel 1e-3,
durations exact); the bucket pick, the capacity escalation and the errors
past the largest bucket; ``stream`` against ``synthesize``; a
multi-speaker artifact; the loader in a process where the port's
``models`` and ``vocoder`` cannot be imported; and the device rule.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu import serving as jax_serving
from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxHiFiGANConfig
from smart_nar_fast_tts_tpu_torch import config as tcfg
from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
from smart_nar_fast_tts_tpu_torch.serving import (ExportedTTS,
                                                  export_serving_artifacts)
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator)
from smart_nar_fast_tts_tpu_torch.weights import (jax_to_torch_acoustic,
                                                  jax_to_torch_hifigan)
from test_serving_export import _tiny_model
from torch_port_util import (REPO, flatten, init_acoustic, init_hifigan,
                             one_torch_thread,  # noqa: F401
                             random_variables)

TEXT_BUCKETS = (8, 16)
MEL_CAPS = (128, 256)
MEL_BUCKETS = (128, 256)
STREAM_CHUNK = 16
MEL_ATOL = 1e-3
VOCODER = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
               upsample_initial_channel=8, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 2),), n_mels=80)
OPS = ("smart_tts.flash_attention", "smart_tts.gaussian_upsample_banded")


def _as_init(path, a):
    """Biases and means 0, norm scales and variances 1, as an init."""
    name = str(path[-1].key)
    if name in ("bias", "mean"):
        return np.zeros_like(a)
    return np.ones_like(a) if name in ("scale", "var") else a


def _acoustic_pair(frames_per_phoneme, multi_speaker=False, n_speakers=1,
                   seed=0):
    """The JAX tiny model with seeded weights and the port's twin."""
    jax_model, pre = _tiny_model(multi_speaker, n_speakers)
    _, shapes = init_acoustic(jax_model.cfg, pre)
    variables = jax.tree_util.tree_map_with_path(
        _as_init, random_variables(shapes, seed))
    variables["params"]["variance_adaptor"]["duration_predictor"][
        "linear_layer"]["bias"] += np.log(frames_per_phoneme + 1.0)
    jc = jax_model.cfg
    t = jc.transformer
    cfg = tcfg.ModelConfig(
        transformer=tcfg.TransformerConfig(**dataclasses.asdict(t)),
        variance_predictor=tcfg.VariancePredictorConfig(filter_size=16),
        variance_embedding=tcfg.VarianceEmbeddingConfig(n_bins=16),
        max_seq_len=jc.max_seq_len, multi_speaker=multi_speaker,
        n_speakers=n_speakers)
    port = FastSpeech2Align(cfg, tcfg.PreprocessConfig(
        stats=tcfg.FeatureStats(**dataclasses.asdict(pre.stats))))
    port.load_state_dict(jax_to_torch_acoustic(flatten(variables), cfg))
    return jax_model, variables, port.eval()


def _vocoder_pair(seed):
    jax_gen, shapes = init_hifigan(JaxHiFiGANConfig(**VOCODER,
                                                    tail_impl="plain"))
    variables = random_variables(shapes, seed)
    config = HiFiGANConfig(**VOCODER)
    gen = HiFiGANGenerator(config)
    gen.load_state_dict(jax_to_torch_hifigan(flatten(variables), config))
    return jax_gen, variables, gen.eval()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("artifact")
    jax_model, variables, port = _acoustic_pair(11.0)
    jax_gen, gen_vars, gen = _vocoder_pair(seed=1)
    manifest = export_serving_artifacts(
        str(out), port, text_buckets=TEXT_BUCKETS, mel_buckets=MEL_BUCKETS,
        batch_size=1, max_mel_len=128, mel_caps=MEL_CAPS, generator=gen,
        stream_chunk=STREAM_CHUNK, device="cpu",
        provenance={"test": "round-trip"})
    return dict(out=out, jax_model=jax_model, variables=variables, port=port,
                gen=gen, manifest=manifest,
                tts=ExportedTTS(str(out), device="cpu"))


def _programs(manifest):
    return (manifest["probe"] + manifest["acoustic"] + manifest["vocoder"]
            + [manifest["streaming"]])


def test_manifest_and_files_match_jax(artifact, tmp_path, monkeypatch):
    """The JAX export of the same model, its programs stubbed: the same
    manifest keys (``device`` for ``platforms``), entries and file stems."""
    out, manifest = artifact["out"], artifact["manifest"]
    monkeypatch.setattr(jax_serving, "_export_one",
                        lambda fn, args, path, platforms: open(
                            path, "wb").close())
    jax_gen, shapes = init_hifigan(JaxHiFiGANConfig(**VOCODER))
    gen_vars = random_variables(shapes, seed=1)
    theirs = jax_serving.export_serving_artifacts(
        str(tmp_path), artifact["jax_model"], artifact["variables"],
        text_buckets=TEXT_BUCKETS, mel_buckets=MEL_BUCKETS, batch_size=1,
        max_mel_len=128, mel_caps=MEL_CAPS, generator=jax_gen,
        gen_variables=gen_vars, stream_chunk=STREAM_CHUNK,
        provenance={"test": "round-trip"})
    assert set(manifest) == set(theirs) - {"platforms"} | {"device"}
    assert manifest["device"] == "cpu"
    assert json.loads((out / "manifest.json").read_text()) == manifest
    for key in ("batch_size", "multi_speaker", "controls", "vocoder_hop",
                "streaming", "provenance"):
        if key == "streaming":
            stem = theirs[key]["file"].rsplit(".", 1)[0]
            assert manifest[key] == dict(theirs[key], file=stem + ".pt2")
        else:
            assert manifest[key] == theirs[key], key
    for kind in ("probe", "acoustic", "vocoder"):
        assert len(manifest[kind]) == len(theirs[kind])
        for mine, jax_entry in zip(manifest[kind], theirs[kind]):
            assert mine["file"].rsplit(".", 1) == [
                jax_entry["file"].rsplit(".", 1)[0], "pt2"]
            assert ({k: v for k, v in mine.items()
                     if k not in ("file", "inputs")}
                    == {k: v for k, v in jax_entry.items()
                        if k not in ("file", "inputs")})
    assert set(manifest["params"]) == set(theirs["params"])
    assert (out / "params.npz").is_file()
    for entry in _programs(manifest):
        assert (out / entry["file"]).is_file()
    assert manifest["streaming"]["window_frames"] == (
        STREAM_CHUNK + 2 * manifest["streaming"]["halo_frames"])


def test_weights_stored_once(artifact):
    """No program file holds a tensor (the weights, the example inputs, a
    constant): together they are well under ``params.npz``."""
    out, manifest = artifact["out"], artifact["manifest"]
    with np.load(out / "params.npz") as npz:
        n_port = sum(1 for _ in artifact["port"].named_parameters()) + sum(
            1 for _ in artifact["port"].named_buffers())
        assert len(npz.files) == n_port + len(artifact["gen"].state_dict())
    program_bytes = 0
    for entry in _programs(manifest):
        path = out / entry["file"]
        program_bytes += path.stat().st_size
        with zipfile.ZipFile(path) as z:
            # weights and constants would sit under data/weights and
            # data/constants; data/sample_inputs holds the pickled None
            data = [(i.filename, i.file_size) for i in z.infolist()
                    if "/data/" in i.filename
                    and not i.filename.endswith(".json")
                    and not ("/sample_inputs/" in i.filename
                             and i.file_size < 1024)]
        assert data == [], (entry["file"], data)
    assert program_bytes < 0.2 * (out / "params.npz").stat().st_size


def _op_counts(program):
    """Calls of each registered kernel operator in a loaded program."""
    targets = [str(n.target) for n in program.call.graph.nodes]
    return {op: sum(t.startswith(op) for t in targets) for op in OPS}


def test_programs_call_the_registered_ops(artifact):
    tts = artifact["tts"]
    assert len(tts._probe) == len(TEXT_BUCKETS)
    assert len(tts._acoustic) == len(TEXT_BUCKETS) * len(MEL_CAPS)
    for program in tts._probe + tts._acoustic:
        assert _op_counts(program) == {
            "smart_tts.flash_attention": 0,
            "smart_tts.gaussian_upsample_banded": 1}, program.bucket


def _live(port, ids, cap, speaker=None):
    """The port's live model on the ids padded to their text bucket."""
    texts = np.zeros((1, next(b for b in TEXT_BUCKETS if len(ids) <= b)),
                     np.int64)
    texts[0, :len(ids)] = ids
    with torch.no_grad():
        return port(torch.from_numpy(texts), torch.tensor([len(ids)]),
                    max_mel_len=cap,
                    speakers=None if speaker is None
                    else torch.tensor([speaker]))


def test_acoustic_equals_live_models(artifact):
    tts, port = artifact["tts"], artifact["port"]
    ids = np.array([5, 9, 2, 7, 11, 3])
    got = tts.acoustic(ids)
    cap = got["postnet_mel"].shape[1]
    live = _live(port, ids, cap)
    for key in ("postnet_mel", "mel_lens", "duration_rounded",
                "pitch_prediction", "energy_prediction"):
        np.testing.assert_array_equal(got[key],
                                      getattr(live, key).numpy(), key)
    texts = np.zeros((1, 8), np.int32)
    texts[0, :6] = ids
    expect = jax.jit(lambda v, t, s: artifact["jax_model"].apply(
        v, t, s, max_mel_len=cap))(artifact["variables"], jnp.asarray(texts),
                                   jnp.asarray([6], jnp.int32))
    np.testing.assert_array_equal(got["duration_rounded"],
                                  np.asarray(expect.duration_rounded))
    np.testing.assert_array_equal(got["mel_lens"],
                                  np.asarray(expect.mel_lens))
    np.testing.assert_allclose(got["postnet_mel"],
                               np.asarray(expect.postnet_mel),
                               atol=MEL_ATOL, rtol=0)


def test_bucket_pick_and_escalation(artifact):
    tts = artifact["tts"]
    short, long_ids = np.array([5, 9, 2]), np.arange(2, 18)
    n_short, n_long = (tts.predicted_frames(short),
                       tts.predicted_frames(long_ids))
    assert 0 < n_short <= MEL_CAPS[0] < n_long <= MEL_CAPS[1]
    got_s, got_l = tts.acoustic(short), tts.acoustic(long_ids)
    assert got_s["duration_rounded"].shape[1] == 8
    assert got_l["duration_rounded"].shape[1] == 16
    assert got_s["postnet_mel"].shape[1] == MEL_CAPS[0]
    assert got_l["postnet_mel"].shape[1] == MEL_CAPS[1]
    assert int(got_l["mel_lens"][0]) == n_long          # not clipped
    with pytest.raises(ValueError, match="largest exported bucket"):
        tts.acoustic(np.arange(2, 2 + 17))


def test_frames_past_the_largest_capacity_raise(artifact, monkeypatch):
    """With the 256-frame programs left out, the long text's 129+ frames
    pass the largest capacity: an error, never truncated speech."""
    tts = artifact["tts"]
    monkeypatch.setattr(tts, "_acoustic", [p for p in tts._acoustic
                                           if p.mel_cap == MEL_CAPS[0]])
    with pytest.raises(ValueError, match="largest exported frame capacity"):
        tts.acoustic(np.arange(2, 18))


def test_stream_equals_synthesize(artifact):
    tts, gen = artifact["tts"], artifact["gen"]
    for ids in (np.arange(2, 16), np.array([5, 9])):
        t = int(tts.acoustic(ids)["mel_lens"][0])
        wav = tts.synthesize(ids)
        assert wav.shape == (t * gen.config.hop_length,)
        assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
        chunks = list(tts.stream(ids))
        assert len(chunks) == -(-t // STREAM_CHUNK)
        for c in chunks[:-1]:
            assert c.shape == (STREAM_CHUNK * tts.hop,)
        np.testing.assert_allclose(np.concatenate(chunks), wav, atol=1e-6,
                                   rtol=0)
        # the vocoder program equals the live generator on the bucket mel
        out = tts.acoustic(ids)
        bucket = next(b for b in MEL_BUCKETS if t <= b)
        mel = np.zeros((1, bucket, 80), np.float32)
        mel[0, :t] = out["postnet_mel"][0, :t]
        with torch.no_grad():
            live = gen(torch.from_numpy(mel))[0, :wav.shape[0]].numpy()
        np.testing.assert_array_equal(wav, live)


@pytest.fixture(scope="module")
def speaker_artifact(tmp_path_factory):
    """4 speakers, one text bucket and one frame capacity, 2056 (past
    2048: the decoder's self-attention takes the flash operator)."""
    out = tmp_path_factory.mktemp("speaker_artifact")
    _, _, port = _acoustic_pair(19.0, multi_speaker=True, n_speakers=4,
                                seed=2)
    _, _, gen = _vocoder_pair(seed=3)
    export_serving_artifacts(
        str(out), port, text_buckets=(8,), mel_buckets=(2056,),
        batch_size=1, max_mel_len=128, mel_caps=(2056,), generator=gen,
        stream_chunk=STREAM_CHUNK, device="cpu")
    return out, port


def test_speaker_input_and_flash_in_a_program(speaker_artifact):
    out, port = speaker_artifact
    tts = ExportedTTS(str(out), device="cpu")
    assert tts.multi_speaker
    assert _op_counts(tts._acoustic[0]) == {
        "smart_tts.flash_attention": 1,
        "smart_tts.gaussian_upsample_banded": 1}
    ids = np.array([5, 9, 2, 7, 11, 3, 8, 4])
    got = tts.acoustic(ids, speaker=2)
    assert got["postnet_mel"].shape[1] == 2056
    live = _live(port, ids, 2056, speaker=2)
    np.testing.assert_array_equal(got["postnet_mel"],
                                  live.postnet_mel.numpy())
    other = tts.acoustic(ids, speaker=1)
    assert not np.allclose(other["postnet_mel"], got["postnet_mel"])


BLOCKED = ("jax", "flax", "smart_nar_fast_tts_tpu",
           "smart_nar_fast_tts_tpu_torch.models",
           "smart_nar_fast_tts_tpu_torch.vocoder")


def test_loader_needs_no_model_classes(speaker_artifact):
    """``ExportedTTS`` in a fresh process where the port's ``models`` and
    ``vocoder`` packages (and JAX) cannot be imported."""
    out, _ = speaker_artifact
    code = ("import sys\n"
            f"for name in {BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "from smart_nar_fast_tts_tpu_torch.serving import ExportedTTS\n"
            f"tts = ExportedTTS({str(out)!r}, device='cpu')\n"
            "wav = tts.synthesize([5, 9, 2, 7], speaker=3)\n"
            "print(wav.shape[0], tts.hop)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    samples, hop = map(int, res.stdout.split())
    assert samples > 0 and samples % hop == 0


def test_export_refuses_what_it_cannot_serve(artifact, tmp_path):
    with pytest.raises(ValueError, match="stream_chunk"):
        export_serving_artifacts(str(tmp_path / "bad"), artifact["port"],
                                 text_buckets=[16], mel_buckets=[64],
                                 stream_chunk=0, device="cpu")
    # a generator needs the vocoder surface: a config with n_mels and hop
    with pytest.raises(AttributeError, match="config"):
        export_serving_artifacts(str(tmp_path / "bad"), artifact["port"],
                                 text_buckets=[16], mel_buckets=[64],
                                 generator=torch.nn.Conv1d(80, 1, 1),
                                 device="cpu")


def test_artifact_for_another_device_raises(artifact, tmp_path):
    """An artifact is served on the device it was exported for; without a
    card, the default (CUDA) raises as every entry point does."""
    manifest = dict(artifact["manifest"], device="cuda")
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="re-export"):
        ExportedTTS(str(tmp_path), device="cpu")
    shutil.copy(artifact["out"] / "manifest.json", tmp_path)
    if torch.cuda.is_available():
        pytest.skip("the no-card case needs a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExportedTTS(str(tmp_path))
    assert os.path.isfile(tmp_path / "manifest.json")
