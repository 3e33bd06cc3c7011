"""FastSpeech 2 with a learned alignment: the port's ``FastSpeech2Align``
behind its ``Synthesizer``, and its training step, against
``reference/fastspeech2.py``.

Weights: the seed's draw at the initialisers' scales; for serving, the
duration head's weight scaled by the configuration's
``weights.duration_head_scale`` and its bias bisected on the reference's
own pass, so that every seed's model speaks ``weights.frames_per_phoneme``
frames a phoneme (the same work for every seed); training starts from the
draw itself.

The program takes two kinds of discrete decision, which the reference
follows and which are counted apart (``Decisions``): each phoneme's
duration and each frame's pitch and energy bin.  A decision taken at a
rounding boundary flips with the last bit of its input and moves what
follows by whole units.  Training takes a third, each frame's phoneme by
the aligner's argmax (the duration targets): the reference follows the
program's and counts where its own differ (``target_mismatch``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.harness import check, flops, traffic, weights
from portbench.reference import fastspeech2 as ref
from portbench.reference import train as ref_train

HEAD = "variance_adaptor.duration_predictor.linear_layer"
# the loss terms' order (LossBreakdown's): total first, the guided prior last
GUIDED = 6
ALIGNER = "mel_encoder."


def draw(a: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The seed's weights of the ``acoustic`` part, as drawn."""
    return weights.make(ref.shapes(a), seed, weights.ACOUSTIC, device)


def tiny(a: dict) -> None:
    """Small widths and depths, in place."""
    a["transformer"].update(
        encoder_layer=1, decoder_layer=2, encoder_hidden=32,
        decoder_hidden=32, conv_filter_size=64)
    a["variance_predictor"]["filter_size"] = 32


# ------------------------------------------------------------- the port

def acoustic_config(cfg: dict):
    from smart_nar_fast_tts_tpu_torch.config import (
        ModelConfig, TransformerConfig, VarianceEmbeddingConfig,
        VariancePredictorConfig)
    a = cfg["acoustic"]
    t = dict(a["transformer"])
    t["conv_kernel_size"] = tuple(t["conv_kernel_size"])
    return ModelConfig(
        transformer=TransformerConfig(**t),
        variance_predictor=VariancePredictorConfig(**a["variance_predictor"]),
        variance_embedding=VarianceEmbeddingConfig(**a["variance_embedding"]),
        max_seq_len=a["max_seq_len"], n_mel_channels=a["n_mel_channels"],
        upsampling=a["upsampling"], gaussian_sigma=a["gaussian_sigma"],
        duration_extraction=a["duration_extraction"],
        duration_head_reduce=a["duration_head_reduce"],
        guided_sigma=a["guided_sigma"],
        compute_dtype=cfg["precision"]["dtype"])


def preprocess_config(cfg: dict):
    from smart_nar_fast_tts_tpu_torch.config import (FeatureStats,
                                                     PreprocessConfig)
    return PreprocessConfig(stats=FeatureStats(**cfg["acoustic"]["stats"]))


def build(cfg: dict, W: dict) -> torch.nn.Module:
    """The port's ``FastSpeech2Align`` with ``W`` (on their device)."""
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Align
    return weights.module(lambda: FastSpeech2Align(
        acoustic_config(cfg), preprocess_config(cfg)), W)


# -------------------------------------------------------------- serving

class Serving:
    """The acoustic side of serving: the calibrated weights, the port's
    ``Synthesizer``, what the check reads of a timed batch, and the
    reference's output for it."""

    def __init__(self, cfg, spec, seed, device, mix):
        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.a = cfg["acoustic"]
        self.bias = self._calibrate(mix)

    def weights(self, calibrated: bool = True):
        """The seed's weights; ``calibrated``: the duration head's bias set
        by ``_calibrate``."""
        W = draw(self.a, self.seed, self.device)
        W[HEAD + ".weight"] = W[HEAD + ".weight"] * \
            self.cfg["weights"]["duration_head_scale"]
        if calibrated:
            W[HEAD + ".bias"] = torch.full_like(W[HEAD + ".bias"], self.bias)
        return W

    @torch.inference_mode()
    def _calibrate(self, mix) -> float:
        """The duration head's bias: the one at which the reference's own
        durations over the mix's phonemes total F frames a phoneme
        (bisection on the head's output before its bias), so that every
        seed's model speaks the same number of frames."""
        W = self.weights(calibrated=False)
        ids, lens = traffic.pad(mix.sentences, [max(
            len(s) for s in mix.sentences)])
        ids, lens = torch.as_tensor(ids, device=self.device), \
            torch.as_tensor(lens, device=self.device)
        log_d, valid = ref.log_durations(W, self.a, ids, lens)
        b = float(W[HEAD + ".bias"])
        pre = (log_d - b)[valid].double().cpu().numpy()
        target = self.cfg["weights"]["frames_per_phoneme"] * len(pre)
        lo, hi = -20.0, 20.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            frames = np.maximum(np.round(np.exp(pre + mid) - 1.0), 0).sum()
            lo, hi = (mid, hi) if frames < target else (lo, mid)
        return hi

    def build(self, W, vocoder):
        from smart_nar_fast_tts_tpu_torch.serving import Synthesizer
        return Synthesizer(build(self.cfg, W), vocoder, device=self.device,
                           t_cap=self.spec["t_cap"])

    @staticmethod
    def synthesize(synth, batch):
        """(waveforms, mel_lens) on the device."""
        return synth.synthesize(batch.ids, batch.lens)

    @staticmethod
    def stage_a(synth, batch):
        """(mel (B, T, n_mels), mel_lens) on the device."""
        out = synth.stage_a(torch.as_tensor(batch.ids),
                            torch.as_tensor(batch.lens))
        return out.postnet_mel, out.mel_lens

    @staticmethod
    def captured(synth) -> torch.nn.Module:
        """The module whose output the check reads."""
        return synth.model

    def warm(self, synth):
        """Open mode's set-up: every batch size at the longest text bucket
        through stage A, and at every vocoder bucket through stage B."""
        n_mels = self.a["n_mel_channels"]
        L = max(self.spec["text_buckets"])
        for b in range(1, self.spec["max_batch"] + 1):
            ids = np.ones((b, L), dtype=np.int64)
            synth.stage_a(torch.as_tensor(ids),
                          torch.full((b,), L, dtype=torch.long))
            for t in self.spec["vocoder_buckets"]:
                synth.stage_b(torch.zeros((b, t, n_mels), device=self.device))

    @staticmethod
    def keep(out) -> dict:
        """Copies, on the device, of what the check reads of a timed
        batch's output."""
        return {"dur": out.duration_rounded.detach().clone(),
                "mel": out.postnet_mel.detach().clone(),
                "pitch": out.pitch_prediction.detach().clone(),
                "energy": out.energy_prediction.detach().clone()}

    def settle(self, kept: dict):
        """(mel (B, T, n_mels), its decisions: durations (B, L) and bins
        (2, B, T)) on the host."""
        return check.to_host(kept["mel"]), (
            check.to_host(kept["dur"]),
            self.bins(kept["pitch"], kept["energy"]))

    @staticmethod
    def record(out) -> dict:
        """A traced batch's text and frame axes and its durations (the
        upsampling kernel's roofline)."""
        return {"L": int(out.duration_rounded.shape[1]),
                "T": int(out.mel_valid.shape[1]),
                "durations": check.to_host(out.duration_rounded)}

    def bins(self, pitch, energy) -> np.ndarray:
        """(2, B, T) pitch and energy bin indices of the predictions, by the
        configuration's quantization."""
        st, n = self.a["stats"], self.a["variance_embedding"]["n_bins"]
        return np.stack([check.to_host(torch.bucketize(x, ref.bins(
            st[f"{f}_min"], st[f"{f}_max"], n, x.device))).astype(np.int64)
            for f, x in (("pitch", pitch), ("energy", energy))])

    def reference(self, W, batch, force=None, low=None):
        """The reference's mel (on the device), mel_lens, own decisions and
        the decisions it took: ``force`` (the judged side's) where given;
        ``low``: the attention's type past the bf16 length."""
        dev = self.device
        ro = ref.forward(
            W, self.a, torch.as_tensor(batch.ids, device=dev),
            torch.as_tensor(batch.lens, device=dev), t_cap=self.spec["t_cap"],
            bf16_past=self.cfg["precision"]["attention_bf16_past"],
            low=low or torch.bfloat16,
            force_durations=None if force is None else
            torch.as_tensor(force[0], device=dev),
            force_bins=None if force is None else
            torch.as_tensor(force[1], device=dev))
        bins = check.to_host(ro.own_bins).astype(np.int64)
        own = (check.to_host(ro.own_duration), bins)
        used = (check.to_host(ro.duration), bins if force is None
                else np.asarray(force[1]))
        return ro.postnet_mel, check.to_host(ro.mel_lens).astype(np.int64), \
            own, used


class Decisions:
    """``dur_mismatch``: the share of the compared batches' phonemes whose
    duration differs from the reference's own; ``bin_mismatch``: the share
    of the compared items' valid frame bins (pitch and energy) that differ
    from the reference's own."""

    def __init__(self):
        self.phonemes = self.mismatched = 0
        self.frames = self.bins_off = 0

    def add(self, got: dict, ref: dict) -> None:
        dur, bins = got["own"]
        rdur, rbins = ref["own"]
        valid = np.arange(rdur.shape[1])[None, :] < ref["lens"][:, None]
        self.phonemes += int(valid.sum())
        self.mismatched += int(((dur != rdur) & valid).sum())
        for i in got["items"]:
            b = bins[:, i, :got["mel_lens"][i]]
            rb = rbins[:, i, :ref["mel_lens"][i]]
            n = min(b.shape[1], rb.shape[1])
            self.frames += rb.size
            self.bins_off += int((b[:, :n] != rb[:, :n]).sum()) + \
                rb.size - 2 * n

    def numbers(self) -> dict[str, float]:
        return {"dur_mismatch": self.mismatched / max(self.phonemes, 1),
                "bin_mismatch": self.bins_off / max(self.frames, 1)}


# ------------------------------------------------------------- training

class Training:
    """The training pieces: the mix's batches, the port's train state and
    step on the seed's weights, and the reference's first steps."""

    def __init__(self, cfg, spec, seed, device, mix):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.batches = _train_batches(spec, mix, seed, device,
                                      cfg["acoustic"]["n_mel_channels"])
        self.feed = [feed(b) for b in self.batches]
        # each batch's shapes and valid lengths on the host
        self.records = [{"src_lens": b["src_np"], "mel_lens": b["mel_np"],
                         "B": len(b["src_np"]),
                         "L": int(b["texts"].shape[1]),
                         "T": int(b["mels"].shape[1])} for b in self.batches]

    def initial(self) -> dict[str, torch.Tensor]:
        return draw(self.cfg["acoustic"], self.seed, self.device)

    def build(self, W):
        return train_program(self.cfg, W, self.device)

    @staticmethod
    @contextlib.contextmanager
    def decisions(model):
        """While open, each forward of ``model`` adds its duration
        targets (the aligner's argmax counted a phoneme) to the dict it
        yields, under ``targets``."""
        taken = {"targets": []}

        def keep(_module, _args, out):
            taken["targets"].append(out.duration_targets.detach().clone())

        hook = model.register_forward_hook(keep)
        try:
            yield taken
        finally:
            hook.remove()

    def reference(self, W0, steps: int, gen_seed: int,
                  judged: dict | None = None) -> dict:
        """The reference's first ``steps`` steps from ``W0``, following
        the judged side's duration targets where it gave one a step of
        each batch's shape (else its own)."""
        t = (judged or {}).get("targets") or []
        shapes = [b["texts"].shape for b in self.batches[:steps]]
        force = [x.to(self.device) for x in t[:steps]] \
            if [x.shape for x in t] == shapes else None
        return ref_train.run(W0, self.cfg, self.batches[:steps], gen_seed,
                             steps, force)

    def numbers(self, got: dict, ref: dict) -> dict[str, float]:
        """The aligner's decisions and two numbers of the aligner.
        ``target_mismatch``: the share of the first steps' valid phonemes
        whose duration target differs from the reference's own (1 where
        the judged side gave none of each batch's shape); the reference
        takes the judged side's, so that an argmax at a near-tie, which
        takes another phoneme with the last bit of its scores and moves a
        target by a frame, moves none of the other numbers.  The guided
        prior (``guided_gap``, each step's, relative) and the first
        gradient of the aligner's own leaves (``aligner_grad_gap``),
        which reach the loss only through that prior and the global
        clip."""
        gl, rl = np.asarray(got["losses"]), np.asarray(ref["losses"])
        aligner = [n for n in ref["grad"] if n.startswith(ALIGNER)]
        rel = np.abs(gl - rl) / np.abs(rl)
        mine = [t.cpu().numpy() for t in got.get("targets", [])]
        own = [t.cpu().numpy() for t in ref["targets"]]
        n = sum(int(r["src_lens"].sum()) for r in self.records[:len(own)])
        off = sum(int((m != o).sum()) for m, o in zip(mine, own)) \
            if [m.shape for m in mine] == [o.shape for o in own] else n
        return {"guided_gap": float(np.max(rel[:, GUIDED])),
                "aligner_grad_gap": check.leaf_gap(got["grad"], ref["grad"],
                                                   aligner),
                "target_mismatch": off / n}


def feed(b: dict):
    """A batch of ``_train_batches`` as the port's train step takes it."""
    from smart_nar_fast_tts_tpu_torch.data.batch import Batch
    return Batch(b["texts"], b["src_lens"], b["mels"], b["mel_lens"],
                 b["pitch"], b["energy"])


def train_program(cfg: dict, W: dict, device):
    """(model, train state, step) of the port on ``W``."""
    from smart_nar_fast_tts_tpu_torch.config import OptimizerConfig
    from smart_nar_fast_tts_tpu_torch.models import FastSpeech2Loss
    from smart_nar_fast_tts_tpu_torch.training import (create_train_state,
                                                       make_train_step)
    o = cfg["optimizer"]
    model = build(cfg, W)
    state = create_train_state(model, OptimizerConfig(
        betas=tuple(o["betas"]), eps=o["eps"],
        weight_decay=o["weight_decay"],
        grad_clip_thresh=o["grad_clip_thresh"],
        warm_up_step=o["warm_up_step"]), device=device)
    step = make_train_step(FastSpeech2Loss(preprocess_config(cfg)))
    return model, state, step


def _train_batches(spec, mix, seed, device, n_mels):
    """The mix's batches on the device: token ids padded to the text
    bucket, frames about ``frames_per_phoneme`` a phoneme (a fixed set of
    jitters in the seed's order) up to ``mel_pad``, and normal mel, pitch
    and energy targets drawn on the device."""
    # the targets' and the jitters' streams
    g = torch.Generator(device=device).manual_seed(traffic.sub_seed(seed, 5))
    rng = np.random.default_rng(traffic.sub_seed(seed, 6))
    n = len(mix.sentences)
    jit = spec["frames_jitter"] * (2.0 * (np.arange(n) + 0.5) / n - 1.0)
    jit = jit[rng.permutation(n)]
    T = spec["mel_pad"]
    out = []
    for b in mix.batches:
        ids, lens = traffic.pad([mix.sentences[i] for i in b],
                                spec["text_buckets"])
        mel_lens = np.minimum(T, np.rint(lens * spec["frames_per_phoneme"]
                                         * (1.0 + jit[b])).astype(np.int64))
        B = len(b)
        out.append({
            "texts": torch.as_tensor(ids, device=device),
            "src_lens": torch.as_tensor(lens, device=device),
            "mels": torch.randn((B, T, n_mels), generator=g, device=device)
            * 2.0 - 5.0,
            "mel_lens": torch.as_tensor(mel_lens, device=device),
            "pitch": torch.randn((B, T), generator=g, device=device),
            "energy": torch.randn((B, T), generator=g, device=device),
            "src_np": lens, "mel_np": mel_lens})
    return out


# ---------------------------------------------------------------- FLOPs

def _fft(n, nk, d, f, k1, k2):
    """One FFT block's forward: projections, attention products, FFN."""
    lin = flops.lin
    proj = lin(n, d, d) * 2 + lin(nk, d, d) * 2        # q, fc ; k, v
    attn = 2 * (2 * n * nk * d)                        # QKᵀ and PV
    ffn = lin(n, d * k1, f) + lin(n, f * k2, d)
    return proj + attn + ffn


def _predictor(n, d, fv, kv):
    lin = flops.lin
    return lin(n, d * kv, fv) + lin(n, fv * kv, fv) + lin(n, fv, 1)


def _postnet(t, n_mels):
    dims = [n_mels] + [512] * 4 + [n_mels]
    return sum(flops.lin(t, dims[i] * 5, dims[i + 1]) for i in range(5))


def forward_flops(a: dict, L: int, T: int) -> int:
    """Inference FLOPs of one item of L phonemes and T frames."""
    tr, vp = a["transformer"], a["variance_predictor"]
    de, dd, f = tr["encoder_hidden"], tr["decoder_hidden"], \
        tr["conv_filter_size"]
    k1, k2 = tr["conv_kernel_size"]
    n_mels = a["n_mel_channels"]
    out = tr["encoder_layer"] * _fft(L, L, de, f, k1, k2)
    out += _predictor(L, de, vp["filter_size"], vp["kernel_size"])
    out += 2 * L * T * de                                      # upsampling
    out += 2 * _predictor(T, de, vp["filter_size"], vp["kernel_size"])
    out += tr["decoder_layer"] * _fft(T, T, dd, f, k1, k2)
    out += flops.lin(T, dd, n_mels) + _postnet(T, n_mels)
    return out


def train_flops(a: dict, L: int, T: int) -> int:
    """Forward and backward FLOPs of one training item: the inference
    path at T frames plus the aligner (prenet, cross-attention blocks).
    The aligner's last block reaches the loss only through head 0's
    scores, so its V, PV, fc and FFN take no backward."""
    lin = flops.lin
    tr = a["transformer"]
    de, dd, f = tr["encoder_hidden"], tr["decoder_hidden"], \
        tr["conv_filter_size"]
    k1, k2 = tr["conv_kernel_size"]
    n_mels = a["n_mel_channels"]
    fwd = forward_flops(a, L, T)
    n_al = tr["decoder_layer"]
    prenet = lin(T, n_mels, dd) + lin(T, dd, dd)
    aligner = n_al * _fft(T, L, dd, f, k1, k2)
    fwd += prenet + aligner
    # backward: 2x every product whose input needs a gradient; the
    # prenet's first layer (input: the target mels) and the upsampling
    # product (its weights come from the aligned durations) 1x
    bwd = 2 * (fwd - prenet - aligner - 2 * L * T * de)
    bwd += lin(T, n_mels, dd) + 2 * lin(T, dd, dd) + 2 * L * T * de
    full = _fft(T, L, dd, f, k1, k2)
    last = lin(T, dd, dd) + lin(L, dd, dd) + 2 * T * L * dd   # q, k, QKᵀ
    bwd += 2 * ((n_al - 1) * full + last)
    return fwd + bwd
