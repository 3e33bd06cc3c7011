"""Serving: the two-stage bucketed :class:`Synthesizer`, and exported
serving artifacts (:func:`export_serving_artifacts`, :class:`ExportedTTS`).

Stage A runs the acoustic model at the full frame capacity ``t_cap`` (the
output length is unknown before the model runs).  The host then reads
``max(mel_lens)`` and picks the smallest mel bucket that holds it, and stage
B runs the vocoder on ``postnet_mel[:, :bucket]`` only, as ``bench.py`` serves
the JAX package.

Exported artifacts are the port of ``smart_nar_fast_tts_tpu/serving.py``'s:
every serving program exported ahead of time by ``torch.export``, with the
weights stored once, as plain arrays, in ``params.npz`` and passed to every
program as inputs (weights as data: each program calls the model through
``torch.func.functional_call`` on its leaves, so no ``.pt2`` holds a copy of
them).  A server needs ``torch``, the port's ``kernels`` (which register the
operators the programs call) and the directory; no model class, config or
checkpoint.  Layout::

    manifest.json                # buckets, shapes, dtypes, device, provenance
    params.npz                   # every leaf once (a%05d / v%05d)
    probe_L{L}.pt2               # (leaves, texts, lens[, speakers]) -> frames
    acoustic_L{L}_T{T}.pt2       # (leaves, texts, lens[, speakers]) -> dict
    vocoder_T{T}.pt2             # (leaves, (B, T, n_mels)) -> (B, T·hop)
    vocoder_stream_W{W}.pt2      # (leaves, (1, W, n_mels)) -> (1, W·hop)

The per-text-bucket probe returns the predicted total frames, so
:class:`ExportedTTS` runs the smallest (text bucket, frame capacity)
acoustic program that holds the utterance, and raises rather than truncate
past the largest.  Two deliberate differences from the JAX format (ROADMAP
§A): the flash-attention and upsampling kernels stay inside the programs as
the registered operators ``smart_tts::flash_attention`` and
``smart_tts::gaussian_upsample_banded`` (the JAX export turns Pallas off:
Mosaic calls carry no guarantee across versions; the port's operators ship
with the port), and a program is exported for one device, named by the
manifest's ``device`` (JAX's ``platforms``): loading it on another raises
and asks for a re-export.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from .device import resolve_device
from .tracing import call_args, span

RESULTS_DIR = Path(__file__).resolve().parent.parent / "benchmarks" / "results"
MEL_BUCKETS = (128, 256, 384, 512, 640, 768, 1000)
T_CAP = 1000


def bucket(n: int) -> int:
    """The smallest mel bucket that holds n frames (the largest if none
    does)."""
    return next((b for b in MEL_BUCKETS if n <= b), MEL_BUCKETS[-1])


def committed_flagship(cfg: Optional[ModelConfig] = None,
                       results_dir: str | Path = RESULTS_DIR,
                       name: str = "flagship") -> FastSpeech2Align:
    """A committed acoustic model (``<name>_params.npz``, with the feature
    stats of ``<name>_meta.json`` and the leaf index
    ``assets/<name>_leaves.json``) on the CPU, built with ``cfg``: the
    model's widths with any duration extraction.  ``name`` is
    ``"flagship"`` or ``"scaled_flagship"`` (8 speakers: ``cfg`` of
    ``configs/scaled/model.yaml``; default ``ModelConfig()``)."""
    from .config import FeatureStats, PreprocessConfig
    from .models import FastSpeech2Align
    from .weights import ASSETS, jax_to_torch_acoustic, load_committed
    results = Path(results_dir)
    meta = json.loads((results / f"{name}_meta.json").read_text())
    if cfg is None:
        from .config import ModelConfig
        cfg = ModelConfig()
    model = FastSpeech2Align(
        cfg, PreprocessConfig(stats=FeatureStats(**meta["stats"])))
    model.load_state_dict(jax_to_torch_acoustic(load_committed(
        results / f"{name}_params.npz", ASSETS / f"{name}_leaves.json"), cfg))
    return model


def committed_vocoder(results_dir: str | Path = RESULTS_DIR,
                      family: str = "hifigan") -> torch.nn.Module:
    """A committed vocoder generator on the CPU: HiFi-GAN V1
    (``vocoder_params.npz`` with the config of ``vocoder_meta.json``), Vocos
    or MelGAN (``<family>_params.npz`` with ``<family>_meta.json``), named
    by the leaf index ``assets/<family>_leaves.json``."""
    from . import weights
    from .vocoder.convert import FAMILIES
    if family not in FAMILIES:
        raise ValueError(f"unknown vocoder family {family!r}")
    stem = "vocoder" if family == "hifigan" else family
    results = Path(results_dir)
    meta = json.loads((results / f"{stem}_meta.json").read_text())
    cfg_cls, gen_cls = FAMILIES[family]
    config = cfg_cls.from_dict(meta["config"])
    vocoder = gen_cls(config)
    to_torch = getattr(weights, f"jax_to_torch_{family}")
    vocoder.load_state_dict(to_torch(weights.load_committed(
        results / f"{stem}_params.npz",
        weights.ASSETS / f"{family}_leaves.json"), config))
    return vocoder


class Synthesizer:
    """Acoustic model + vocoder (a HiFi-GAN, Vocos or MelGAN generator) on
    one device, in eval mode.  Stage B returns the generator's waveform as
    it is: HiFi-GAN and MelGAN end in tanh, Vocos is not clipped."""

    def __init__(self, model: FastSpeech2Align, vocoder: torch.nn.Module,
                 device: str | torch.device | None = None,
                 t_cap: int = T_CAP):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()
        self.t_cap = t_cap
        self.calls = 0          # synthesize calls, numbered in their spans

    @classmethod
    def from_committed(cls, device: str | torch.device | None = None,
                       results_dir: str | Path = RESULTS_DIR,
                       family: str = "hifigan") -> "Synthesizer":
        """The committed flagship acoustic model and vocoder of ``family``
        (default HiFi-GAN V1, the family ``vocoder_quality.json`` picks),
        read from ``flagship_params.npz``, the vocoder's ``.npz`` and their
        meta files (feature stats, vocoder config)."""
        device = resolve_device(device)
        return cls(committed_flagship(results_dir=results_dir),
                   committed_vocoder(results_dir, family), device)

    @property
    def hop_length(self) -> int:
        return self.vocoder.config.hop_length

    @property
    def sampling_rate(self) -> int:
        return self.vocoder.config.sampling_rate

    def audio_seconds(self, mel_lens: torch.Tensor) -> float:
        """Seconds of audio in the valid frames of a batch."""
        return float(mel_lens.sum()) * self.hop_length / self.sampling_rate

    @torch.inference_mode()
    def stage_a(self, token_ids: torch.Tensor, src_lens: torch.Tensor
                ) -> ModelOutput:
        """Text → mel at the full frame capacity."""
        with span("stage_a"):
            return self.model(token_ids.to(self.device),
                              src_lens.to(self.device), max_mel_len=self.t_cap)

    @torch.inference_mode()
    def stage_b(self, mel: torch.Tensor) -> torch.Tensor:
        """Mel (B, T, n_mels) → waveform (B, T·hop)."""
        with span("stage_b"):
            return self.vocoder(mel.to(self.device))

    def synthesize(self, token_ids, src_lens
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """token_ids (B, L) and src_lens (B,) → (waveform (B, bucket·hop),
        mel_lens (B,) int32).  Item i's audio is its first
        ``mel_lens[i]·hop`` samples."""
        token_ids = torch.as_tensor(token_ids, dtype=torch.long)
        src_lens = torch.as_tensor(src_lens, dtype=torch.long)
        self.calls += 1
        with span("synthesize", call_args(self.calls, *token_ids.shape,
                                          self.t_cap)):
            out = self.stage_a(token_ids, src_lens)
            with span("bucket"):
                cap = bucket(int(out.mel_lens.max()))
            wav = self.stage_b(out.postnet_mel[:, :cap])
        return wav, out.mel_lens


# ---------------------------------------------------------------------------
# exported serving artifacts

MANIFEST = "manifest.json"
PARAMS_FILE = "params.npz"
# frame capacity of the probe programs: duration_rounded is exact at any
# capacity (computed before the length regulator), so the smallest one
# keeps the rest of the probe cheap
PROBE_CAP = 8


def _leaves(module: torch.nn.Module) -> tuple[list[str], list[torch.Tensor]]:
    """A module's parameters and buffers (BatchNorm statistics, PE tables and
    quantization bins included), by name, in a fixed order."""
    named = list(module.named_parameters()) + list(module.named_buffers())
    return [n for n, _ in named], [t.detach() for _, t in named]


class _Program(torch.nn.Module):
    """``fn(target, *inputs)`` with the target module's leaves swapped for
    the program's first input (``torch.func.functional_call``).  The target
    is held outside the module tree, so ``torch.export`` lifts none of its
    tensors into the program."""

    def __init__(self, target: torch.nn.Module, names: list[str],
                 fn: Callable):
        super().__init__()
        object.__setattr__(self, "_target", target)
        self._names, self._fn = names, fn

    def forward(self, leaves: list[torch.Tensor], *inputs):
        state = dict(zip(self._names, leaves))

        def call(*args, **kwargs):
            return torch.func.functional_call(self._target, state, args,
                                              kwargs, strict=True)
        return self._fn(call, *inputs)


# node metadata that only traces a node back to its source: left out of the
# saved programs (it would double their size and name the exporting tree)
_SOURCE_META = ("stack_trace", "nn_module_stack", "torch_fn",
                "source_fn_stack")


def _export_one(program: _Program, args: tuple, path: str) -> None:
    with torch.no_grad():
        ep = torch.export.export(program, args, strict=False)
    ep.example_inputs = None        # they hold the leaves: weights, baked
    for node in ep.graph.nodes:
        for key in _SOURCE_META:
            node.meta.pop(key, None)
    torch.export.save(ep, path)


def export_serving_artifacts(
    out_dir: str,
    model: torch.nn.Module,
    *,
    text_buckets: Sequence[int],
    mel_buckets: Sequence[int],
    batch_size: int = 1,
    max_mel_len: int = 1000,
    mel_caps: Optional[Sequence[int]] = None,
    generator: Optional[torch.nn.Module] = None,
    stream_chunk: int = 64,
    p_control: float = 1.0, e_control: float = 1.0, d_control: float = 1.0,
    device: str | torch.device | None = None,
    provenance: Optional[Mapping] = None,
) -> dict:
    """Export the serving surface of ``model`` (a ``FastSpeech2Align``)
    and, when given, ``generator`` (a HiFi-GAN, Vocos or MelGAN generator;
    its program returns the waveform unclipped) into ``out_dir``
    for ``device`` (default CUDA; the modules are moved there and set to
    eval mode); returns the manifest.  ``mel_caps`` are the acoustic frame
    capacities exported per text bucket (default ``max_mel_len`` alone);
    the weights are stored once, in ``params.npz``."""
    if int(stream_chunk) < 1:
        # StreamingVocoder's rule, caught here rather than at serving time
        raise ValueError(f"stream_chunk must be >= 1, got {stream_chunk}")
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    B = int(batch_size)
    caps = sorted(set(int(c) for c in (mel_caps or (max_mel_len,))))
    multi_speaker = bool(model.cfg.multi_speaker)
    model = model.to(device).eval()
    a_names, a_leaves = _leaves(model)
    npz = {f"a{i:05d}": t.cpu().numpy() for i, t in enumerate(a_leaves)}
    manifest: dict = {
        "format": "torch.export ExportedProgram (.pt2) + params.npz "
                  "(weights as data)",
        "batch_size": B,
        "multi_speaker": multi_speaker,
        "device": device.type,
        "controls": {"p": p_control, "e": e_control, "d": d_control},
        "params": {"file": PARAMS_FILE, "acoustic_leaves": len(a_leaves),
                   "vocoder_leaves": 0},
        "probe": [], "acoustic": [], "vocoder": [],
        "provenance": dict(provenance or {}),
    }

    def run(call, texts, src_lens, speakers, cap):
        return call(texts, src_lens, max_mel_len=cap, speakers=speakers,
                    p_control=p_control, e_control=e_control,
                    d_control=d_control)

    def acoustic_fn(cap):
        def fn(call, texts, src_lens, speakers=None):
            out = run(call, texts, src_lens, speakers, cap)
            return {"postnet_mel": out.postnet_mel, "mel_lens": out.mel_lens,
                    "duration_rounded": out.duration_rounded,
                    "pitch_prediction": out.pitch_prediction,
                    "energy_prediction": out.energy_prediction}
        return fn

    def probe_fn(call, texts, src_lens, speakers=None):
        out = run(call, texts, src_lens, speakers, PROBE_CAP)
        return out.duration_rounded.sum(dim=-1).to(torch.int32)

    for L in sorted(set(int(b) for b in text_buckets)):
        args = [a_leaves, torch.zeros((B, L), dtype=torch.long, device=device),
                torch.ones((B,), dtype=torch.long, device=device)]
        inputs = ["params leaves", f"int64[{B},{L}] texts",
                  f"int64[{B}] src_lens"]
        if multi_speaker:
            args.append(torch.zeros((B,), dtype=torch.long, device=device))
            inputs.append(f"int64[{B}] speakers")
        name = f"probe_L{L}.pt2"
        _export_one(_Program(model, a_names, probe_fn), tuple(args),
                    os.path.join(out_dir, name))
        manifest["probe"].append({"file": name, "text_bucket": L})
        for T in caps:
            name = f"acoustic_L{L}_T{T}.pt2"
            _export_one(_Program(model, a_names, acoustic_fn(T)),
                        tuple(args), os.path.join(out_dir, name))
            manifest["acoustic"].append(
                {"file": name, "text_bucket": L, "mel_cap": T,
                 "inputs": inputs})

    if generator is not None:
        from .vocoder.streaming import receptive_halo
        generator = generator.to(device).eval()
        n_mels = generator.config.n_mels
        manifest["vocoder_hop"] = generator.config.hop_length
        v_names, v_leaves = _leaves(generator)
        npz.update({f"v{i:05d}": t.cpu().numpy()
                    for i, t in enumerate(v_leaves)})
        manifest["params"]["vocoder_leaves"] = len(v_leaves)

        def vocoder_fn(call, mel):
            return call(mel)

        def export_vocoder(name, b, t):
            mel = torch.zeros((b, t, n_mels), device=device)
            _export_one(_Program(generator, v_names, vocoder_fn),
                        (v_leaves, mel), os.path.join(out_dir, name))

        for T in sorted(set(int(b) for b in mel_buckets)):
            name = f"vocoder_T{T}.pt2"
            export_vocoder(name, B, T)
            manifest["vocoder"].append(
                {"file": name, "mel_bucket": T,
                 "inputs": ["params leaves",
                            f"float32[{B},{T},{n_mels}] mel"]})
        halo = receptive_halo(generator.config)
        window = int(stream_chunk) + 2 * halo
        name = f"vocoder_stream_W{window}.pt2"
        export_vocoder(name, 1, window)
        manifest["streaming"] = {"file": name, "window_frames": window,
                                 "chunk_frames": int(stream_chunk),
                                 "halo_frames": halo}

    np.savez(os.path.join(out_dir, PARAMS_FILE), **npz)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


@dataclass
class _Loaded:
    call: Callable
    bucket: int
    mel_cap: int = 0


class ExportedTTS:
    """Serve text → mel → wav from an artifact directory alone.

    ``synthesize(token_ids, speaker=0)`` picks the smallest text bucket
    that holds the ids, asks the probe for the predicted frames, runs the
    smallest acoustic program whose capacity holds them, then the smallest
    vocoder program that holds the mel, and cuts the waveform to the
    predicted length.  ``device`` defaults to CUDA and must be the one the
    artifact was exported for."""

    def __init__(self, artifact_dir: str,
                 device: str | torch.device | None = None):
        from . import kernels  # noqa: F401  (registers the operators)
        with open(os.path.join(artifact_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        self.device = resolve_device(device)
        exported_for = self.manifest["device"]
        if self.device.type != exported_for:
            raise ValueError(
                f"the artifact in {artifact_dir} was exported for "
                f"{exported_for!r}, not {self.device.type!r}: re-export it "
                f"with --device {self.device.type}")
        self.batch_size = int(self.manifest["batch_size"])
        self.multi_speaker = bool(self.manifest.get("multi_speaker", False))
        p = self.manifest["params"]
        with np.load(os.path.join(artifact_dir, p["file"])) as npz:
            def read(prefix, n):
                return [torch.from_numpy(npz[f"{prefix}{i:05d}"]).to(
                    self.device) for i in range(n)]
            self._aleaves = read("a", p["acoustic_leaves"])
            self._vleaves = read("v", p["vocoder_leaves"])

        def load(name: str) -> Callable:
            return torch.export.load(
                os.path.join(artifact_dir, name)).module()

        self._probe = sorted(
            (_Loaded(load(e["file"]), e["text_bucket"])
             for e in self.manifest["probe"]), key=lambda q: q.bucket)
        self._acoustic = sorted(
            (_Loaded(load(e["file"]), e["text_bucket"], e["mel_cap"])
             for e in self.manifest["acoustic"]),
            key=lambda q: (q.bucket, q.mel_cap))
        self._vocoder = sorted(
            (_Loaded(load(e["file"]), e["mel_bucket"])
             for e in self.manifest.get("vocoder", [])),
            key=lambda q: q.bucket)
        self.hop = int(self.manifest.get("vocoder_hop", 256))
        st = self.manifest.get("streaming")
        self._stream_prog = load(st["file"]) if st else None
        self.stream_window = int(st["window_frames"]) if st else 0
        self.stream_chunk = int(st["chunk_frames"]) if st else 0
        self.stream_halo = int(st["halo_frames"]) if st else 0

    @staticmethod
    def _pick(programs: list, n: int, what: str) -> _Loaded:
        for p in programs:
            if n <= p.bucket:
                return p
        raise ValueError(
            f"{what} length {n} exceeds the largest exported bucket "
            f"({programs[-1].bucket}); re-export the artifacts with larger "
            f"{what} buckets (truncating silently would drop speech)")

    def _text_args(self, token_ids, speaker: int) -> tuple[int, tuple]:
        ids = np.asarray(token_ids, np.int64).reshape(-1)
        n = ids.shape[0]
        bucket = self._pick(self._probe, n, "text").bucket
        texts = np.zeros((self.batch_size, bucket), np.int64)
        texts[0, :n] = ids
        lens = np.ones((self.batch_size,), np.int64)
        lens[0] = max(n, 1)
        args = [self._aleaves, torch.from_numpy(texts).to(self.device),
                torch.from_numpy(lens).to(self.device)]
        if self.multi_speaker:
            args.append(torch.full((self.batch_size,), int(speaker),
                                   dtype=torch.long, device=self.device))
        return bucket, tuple(args)

    def predicted_frames(self, token_ids, speaker: int = 0) -> int:
        """The probe program: predicted total mel frames of the ids."""
        bucket, args = self._text_args(token_ids, speaker)
        probe = next(p for p in self._probe if p.bucket == bucket)
        with torch.inference_mode():
            return int(probe.call(*args)[0])

    def acoustic(self, token_ids, speaker: int = 0) -> dict:
        """(n,) int token ids → the acoustic outputs (numpy, padded to the
        program's frame capacity)."""
        bucket, args = self._text_args(token_ids, speaker)
        frames = self.predicted_frames(token_ids, speaker)
        fits = [p for p in self._acoustic if p.bucket == bucket]
        prog = next((p for p in fits if frames <= p.mel_cap), None)
        if prog is None:
            raise ValueError(
                f"predicted mel length {frames} exceeds the largest "
                f"exported frame capacity ({fits[-1].mel_cap}); re-export "
                "with larger mel_caps (truncating would drop speech)")
        with torch.inference_mode():
            out = prog.call(*args)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _vocode_program(self, call, mel: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            wav = call(self._vleaves, torch.from_numpy(mel).to(self.device))
        return wav.cpu().numpy()

    def _vocode(self, out: dict) -> np.ndarray:
        """The vocoder tail of :meth:`synthesize`, on acoustic outputs."""
        t = max(int(out["mel_lens"][0]), 1)
        prog = self._pick(self._vocoder, t, "mel")
        mel = np.zeros((self.batch_size, prog.bucket,
                        out["postnet_mel"].shape[-1]), np.float32)
        mel[0, :t] = out["postnet_mel"][0, :t]
        return self._vocode_program(prog.call, mel)[0, : t * self.hop]

    def synthesize(self, token_ids, speaker: int = 0) -> np.ndarray:
        """(n,) int token ids → float32 waveform: the exported generator's
        output (in [-1, 1] for HiFi-GAN and MelGAN; a Vocos one is not
        clipped)."""
        if not self._vocoder:
            raise ValueError("artifact was exported without a vocoder")
        return self._vocode(self.acoustic(token_ids, speaker))

    def stream(self, token_ids, speaker: int = 0):
        """(n,) int token ids → float32 waveform chunks from the streaming
        window program: the first arrives after the probe, the acoustic
        program and one window.  The windows slide over the same
        zero-padded bucket mel that :meth:`synthesize` vocodes, and every
        kept sample lies at least ``halo`` frames from an interior window
        edge, so the chunks concatenate to :meth:`synthesize`'s samples (up
        to the summation order of another shape)."""
        if not self._vocoder:
            raise ValueError("artifact was exported without a vocoder")
        out = self.acoustic(token_ids, speaker)
        t = max(int(out["mel_lens"][0]), 1)
        w, c, h = self.stream_window, self.stream_chunk, self.stream_halo
        prog = self._pick(self._vocoder, t, "mel")
        if self._stream_prog is None or prog.bucket < w:
            # no window program, or a bucket narrower than one window: one
            # chunk through the vocoder tail
            yield self._vocode(out)
            return
        mel = np.zeros((prog.bucket, out["postnet_mel"].shape[-1]),
                       np.float32)
        mel[:t] = out["postnet_mel"][0, :t]
        for lo in range(0, t, c):
            hi = min(lo + c, t)
            start = min(max(lo - h, 0), prog.bucket - w)
            wav = self._vocode_program(self._stream_prog,
                                       mel[None, start: start + w])
            yield wav[0, (lo - start) * self.hop: (hi - start) * self.hop]
