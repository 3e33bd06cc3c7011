"""Synthesis CLI of the port: text → mel → wav/png, on the card.

The same flags as ``python -m smart_nar_fast_tts_tpu.cli.synthesize``
(reference ``synthesize.py:79-128``), plus ``--device``::

    python -m smart_nar_fast_tts_tpu_torch.cli.synthesize \\
        --text "Hello world" --restore_step N \\
        -p preprocess.yaml -m model.yaml -t train.yaml \\
        [--speaker_id K] [--pitch_control 1.0] [--energy_control 1.0] \\
        [--duration_control 1.0] [--vocoder_ckpt generator.pth.tar] \\
        [--device cpu]

    # batch mode: every utterance of a metadata file (name|speaker|
    # {phones}|raw per line) in text-length buckets of --batch_size
    python -m smart_nar_fast_tts_tpu_torch.cli.synthesize \\
        --source val.txt --batch_size 8 ...

It runs on CUDA unless ``--device cpu`` is given, and fails without a card
otherwise.  Checkpoints are the port's own (``training/checkpoint.py``:
``<ckpt_path>/<step>/state.pt``), not the JAX package's orbax ones.  Long
utterances escalate over ``train.serving_mel_caps``: the model runs at the
smallest frame capacity, reads the predicted total duration and runs again
at the smallest capacity that holds it; past 2048 frames the decoder's
self-attention runs the flash kernel.  Vocoding uses the generator of
``--vocoder_ckpt`` when given (any family through ``vocoder.load_vocoder``:
a torch file or a flax ``.msgpack`` with its ``config.json``), else
Griffin-Lim from the predicted mel.  ``--stream_chunk N`` vocodes in windows
of N mel frames plus the receptive-field halo on each side
(``vocoder.StreamingVocoder``: the same samples as one full forward) and
prints the time to the first chunk.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..text import text_to_sequence
from ..text.g2p import G2P
from ._args import add_config_args, load_config


class Utterance(NamedTuple):
    """One synthesised item: what was written and the model's inputs."""
    name: str
    base: str                  # {result_path}/{name}: .wav and .png
    ids: np.ndarray            # (L,) int32 symbol ids
    speaker: int
    cap: int                   # the frame capacity of the run it came from
    duration: np.ndarray       # (L,) rounded durations
    mel_len: int
    postnet_mel: np.ndarray    # (max(mel_len, 4), n_mels) float32
    wav: np.ndarray            # the samples written, float32
    batch: tuple               # (texts (B, L), src_lens (B,), speakers (B,))
    j: int                     # the item's row in ``batch``


def main(argv=None) -> list[Utterance]:
    parser = argparse.ArgumentParser(description=__doc__)
    add_config_args(parser)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             "kernels' plain versions on the CPU)")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--text", type=str, default=None)
    src.add_argument("--source", type=str, default=None,
                     help="metadata file (name|speaker|{phones}|raw per "
                          "line) to synthesize in bucketed batches")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="batch size for --source mode")
    parser.add_argument("--restore_step", type=int, default=None)
    parser.add_argument("--speaker_id", type=int, default=None,
                        help="speaker for --text mode (default 0); in "
                             "--source mode overrides the per-utterance "
                             "metadata speaker column when given")
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help="vocoder generator checkpoint (HiFi-GAN, "
                             "Vocos or MelGAN by its config.json; torch or "
                             "flax .msgpack); Griffin-Lim if omitted")
    parser.add_argument("--stream_chunk", type=int, default=0,
                        help="vocode in fixed windows of this many mel "
                             "frames (+ the receptive-field halo) and "
                             "report time-to-first-audio")
    args = parser.parse_args(argv)
    if args.stream_chunk and not args.vocoder_ckpt:
        parser.error("--stream_chunk requires --vocoder_ckpt")

    cfg = load_config(args)
    device = resolve_device(args.device)
    model, restored = load_model(cfg, args.restore_step, device)
    if restored == 0:
        print("WARNING: no checkpoint found; synthesizing with random init")
    fwd = make_forward(model, cfg, args.pitch_control, args.energy_control,
                       args.duration_control)
    vocode = _make_vocoder(cfg, args.vocoder_ckpt, device, args.stream_chunk)
    os.makedirs(cfg.train.result_path, exist_ok=True)

    if args.text is not None:
        if "{" in args.text:
            phones = args.text          # already ARPAbet-in-braces
        elif cfg.preprocess.language == "en":
            phones = G2P(cfg.preprocess.lexicon_path)(args.text)
        else:
            phones = args.text
        print(f"phonemes: {phones}")
        ids = np.asarray(
            text_to_sequence(phones, list(cfg.preprocess.text_cleaners)),
            np.int64)
        batch = (ids[None], np.asarray([len(ids)], np.int64),
                 np.asarray([args.speaker_id or 0], np.int64))
        out = fwd(*batch)
        utt = _write_outputs(cfg, args.text[:32].replace(" ", "_"),
                             args.text, out, 0, vocode, batch)
        print(f"wrote {utt.base}.wav and {utt.base}.png (ckpt step "
              f"{restored})")
        return [utt]
    utts = _synthesize_source(cfg, args, fwd, vocode)
    print(f"wrote {len(utts)} utterances to {cfg.train.result_path} "
          f"(ckpt step {restored})")
    return utts


def load_model(cfg, restore_step: Optional[int], device: torch.device):
    """``FastSpeech2Align`` of ``cfg`` on ``device`` in eval mode, restored
    from ``cfg.train.ckpt_path`` (the latest step when ``restore_step`` is
    None); returns (model, the step restored, 0 when there was none)."""
    from ..config import check_ported
    from ..models import FastSpeech2Align
    from ..training.checkpoint import CheckpointManager
    from ..training.state import create_train_state

    check_ported(cfg.model)
    state = create_train_state(FastSpeech2Align(cfg.model, cfg.preprocess),
                               cfg.train.optimizer, device)
    state, _ = CheckpointManager(cfg.train.ckpt_path).restore(
        state, step=restore_step)
    return state.model.eval(), state.step


def make_forward(model, cfg, p_control: float = 1.0, e_control: float = 1.0,
                 d_control: float = 1.0):
    """``fwd(texts, src_lens, speakers)`` (host integer arrays) →
    ``ModelOutput`` on the model's device, at the smallest serving frame
    capacity that holds the predicted length.  The one model serves every
    capacity."""
    device = next(model.parameters()).device

    def fwd_at(cap: int):
        @torch.inference_mode()
        def run(texts, src_lens, speakers):
            return model(
                torch.as_tensor(texts, dtype=torch.long, device=device),
                torch.as_tensor(src_lens, dtype=torch.long, device=device),
                max_mel_len=cap,
                speakers=torch.as_tensor(speakers, dtype=torch.long,
                                         device=device),
                p_control=p_control, e_control=e_control,
                d_control=d_control)
        return run

    caps = sorted(set(cfg.train.serving_mel_caps) | {cfg.model.max_seq_len})
    return _auto_cap_forward(fwd_at, caps)


def _auto_cap_forward(fwd_at, caps: list[int]):
    """Long-form serving: run at the smallest frame capacity, read the
    predicted total duration (``duration_rounded`` is exact regardless of
    the capacity — it is computed before the length regulator clips), and
    re-run at the smallest cap that fits.  Fails loudly past the largest
    cap instead of truncating speech."""

    def fwd(*fargs):
        out = fwd_at(caps[0])(*fargs)
        need = int(out.duration_rounded.sum(dim=-1).max())
        cap = next((c for c in caps if need <= c), None)
        if cap is None:
            raise SystemExit(
                f"predicted mel length {need} frames exceeds the largest "
                f"serving capacity ({caps[-1]}); raise "
                "train.serving_mel_caps (truncating would drop speech)")
        if cap != caps[0]:
            print(f"  long utterance: {need} frames -> capacity {cap}")
            out = fwd_at(cap)(*fargs)
        return out

    return fwd


def _synthesize_source(cfg, args, fwd, vocode) -> list[Utterance]:
    """Batch-synthesize every row of a metadata file (the reference's
    ``TextDataset`` path, ``dataset.py:142-191`` + ``synthesize.py:59-77``)
    through text-length buckets, each batch padded to its bucket."""
    from ..data.dataset import TextOnlyDataset

    ds = TextOnlyDataset(args.source, cfg.preprocess)
    caps = sorted(cfg.train.text_buckets)
    buckets: dict[int, list[int]] = {}
    for i in range(len(ds)):
        n = len(ds[i]["text"])
        cap = next((c for c in caps if n <= c), None)
        if cap is None:
            raise SystemExit(
                f"utterance {ds[i]['id']!r} has {n} phonemes, more than the "
                f"largest text bucket ({caps[-1]}); raise "
                f"train.text_buckets (truncating would drop speech)")
        buckets.setdefault(cap, []).append(i)

    written = []
    B = args.batch_size
    for cap in sorted(buckets):
        idxs = buckets[cap]
        for lo in range(0, len(idxs), B):
            chunk = idxs[lo:lo + B]
            texts = np.zeros((B, cap), np.int64)
            src_lens = np.zeros((B,), np.int64)
            speakers = np.zeros((B,), np.int64)
            items = [ds[i] for i in chunk]
            for j, item in enumerate(items):
                t = item["text"]
                texts[j, :len(t)] = t
                src_lens[j] = len(t)
                speakers[j] = (args.speaker_id if args.speaker_id is not None
                               else item["speaker"])
            src_lens = np.maximum(src_lens, 1)      # masked tail slots
            batch = (texts, src_lens, speakers)
            out = fwd(*batch)
            for j, item in enumerate(items):
                written.append(_write_outputs(cfg, item["id"],
                                              item["raw_text"], out, j,
                                              vocode, batch))
    return written


def _write_outputs(cfg, name: str, title: str, out, j: int,
                   vocode: Callable, batch: tuple) -> Utterance:
    """Write ``{result_path}/{name}.wav`` + ``.png`` for batch item ``j``.
    ``title`` is the JAX CLI's figure title; the port's PNG has none
    yet."""
    from ..data.wavio import save_wav
    from ..training.logging import save_mel_png

    # ≥4 frames so the Griffin-Lim fallback's reflect-pad framing is valid
    # even for a random-init model predicting ~zero duration
    n = max(int(out.mel_lens[j]), 4)
    mel = out.postnet_mel[j, :n]                      # (T, n_mels)
    base = os.path.join(cfg.train.result_path, name)
    save_mel_png(base + ".png", mel.T.float().cpu().numpy())
    wav = vocode(mel)
    save_wav(base + ".wav", wav, cfg.preprocess.audio.sampling_rate)
    length = int(batch[1][j])
    return Utterance(
        name=name, base=base, ids=batch[0][j, :length].astype(np.int32),
        speaker=int(batch[2][j]), cap=int(out.postnet_mel.shape[1]),
        duration=out.duration_rounded[j, :length].cpu().numpy(),
        mel_len=int(out.mel_lens[j]), postnet_mel=mel.float().cpu().numpy(),
        wav=wav, batch=batch, j=j)


def _make_vocoder(cfg, vocoder_ckpt, device: torch.device,
                  stream_chunk: int = 0):
    """Return ``mel (T, n_mels) tensor -> wav`` (float32 numpy): the
    checkpoint's generator on ``device`` when one is given (loaded once;
    the waveform times ``max_wav_value``, a Vocos one clipped to [-1, 1]
    first as ``vocos_infer``; in windows of ``stream_chunk`` frames through
    :class:`~..vocoder.StreamingVocoder` when it is not 0), else the
    Griffin-Lim debug fallback (40 iterations, starting phase from a
    generator seeded 0).  A MelGAN runs on the natural-log mel as it is,
    without ``melgan_inverse``'s rescale, as the JAX CLI: its
    ``cli.train_vocoder`` trains it on that mel."""
    from ..audio.stft import MelSpectrogramConfig, griffin_lim
    a = cfg.preprocess.audio
    mcfg = MelSpectrogramConfig(
        sampling_rate=a.sampling_rate, n_fft=a.n_fft,
        hop_length=a.hop_length, win_length=a.win_length, n_mels=a.n_mels,
        mel_fmin=a.mel_fmin, mel_fmax=a.mel_fmax)
    if vocoder_ckpt:
        from ..vocoder import VocosGenerator
        from ..vocoder.convert import load_vocoder
        gen = load_vocoder(vocoder_ckpt).to(device)
        scale = cfg.preprocess.audio.max_wav_value
        clip = isinstance(gen, VocosGenerator)
        if stream_chunk:
            return _streaming_vocoder(gen, stream_chunk, scale, clip)

        @torch.inference_mode()
        def _vocode(mel: torch.Tensor) -> np.ndarray:
            # scaled as the JAX package's hifigan_infer / vocos_infer;
            # save_wav then normalises by the peak, as it does there
            wav = gen(mel[None].float())[0]
            return ((wav.clamp(-1.0, 1.0) if clip else wav)
                    * scale).cpu().numpy()
        return _vocode

    # invert log-mel → linear magnitude via the filterbank pseudo-inverse
    # (debug-quality audio)
    inv = torch.from_numpy(np.linalg.pinv(np.asarray(mcfg.mel_basis)).astype(
        np.float32)).to(device)                       # (n_bins, n_mels)

    @torch.inference_mode()
    def _gl(mel: torch.Tensor) -> np.ndarray:
        mag = torch.clamp(inv @ torch.exp(mel.float().T), min=0.0)
        gen = torch.Generator(device).manual_seed(0)
        return griffin_lim(mag[None], mcfg, n_iters=40,
                           generator=gen)[0].cpu().numpy()
    return _gl


def _streaming_vocoder(gen, stream_chunk: int, scale: float, clip: bool):
    """``mel -> wav`` through :class:`~..vocoder.StreamingVocoder`, clipped
    and scaled as the full forward's path (so that both write the same
    file), printing the time to the first chunk as the JAX CLI does."""
    import time

    from ..vocoder import StreamingVocoder
    sv = StreamingVocoder(gen, chunk_frames=stream_chunk)

    def _stream(mel: torch.Tensor) -> np.ndarray:
        t0 = time.perf_counter()
        chunks = []
        for i, c in enumerate(sv.synthesize_chunks(mel.float().cpu().numpy())):
            if i == 0:
                dt = time.perf_counter() - t0
                print(f"  first audio ({c.shape[0]} samples) after "
                      f"{dt * 1e3:.1f} ms (window={sv.window_frames} "
                      f"frames, halo={sv.halo})")
            chunks.append(c)
        wav = np.concatenate(chunks)
        return (np.clip(wav, -1.0, 1.0) if clip else wav) * scale
    return _stream


if __name__ == "__main__":
    main()
