"""Vocoder GAN training, as ``smart_nar_fast_tts_tpu/training/vocoder.py``,
for any ``mel → wav`` generator (HiFi-GAN, Vocos, MelGAN): a two-optimizer
step (discriminator update, then generator
update with adversarial, feature-matching and mel losses), with the input
mel and the real branch of the mel loss made on the device by the
``fused_log_mel`` kernel from raw waveform segments.

PyTorch runs eagerly, so the JAX package's ``steps_per_dispatch > 1`` (a
``lax.scan`` of steps in one dispatch) has no counterpart here.  On a mesh
(``parallel/``, one process per card) the step takes the global batch, as
JAX's sharded step does (``training/vocoder.py:186-196`` there), and each
rank computes its rows along ``data_axis``: the shards are equal, so every
mean loss of the global batch is the ranks' mean, and each update's
gradients and the reported metrics are averaged over the data group.  The
discriminator's spectral-norm state stays alike on every rank, as the
weights do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..audio.stft import MelSpectrogramConfig
from ..device import resolve_device
from ..kernels import fused_log_mel
from ..parallel import Mesh, all_reduce, batch_sharding, reduce_over_mesh
from ..tracing import span
from ..vocoder.discriminators import HiFiGANDiscriminator
from ..vocoder.losses import (FM_WEIGHT, MEL_WEIGHT, discriminator_loss,
                              feature_matching_loss,
                              generator_adversarial_loss, mel_l1_loss)


class VocoderMetrics(NamedTuple):
    disc: torch.Tensor
    gen_adv: torch.Tensor
    feature: torch.Tensor
    mel: torch.Tensor
    gen_total: torch.Tensor


# optax.adamw's defaults (torch's AdamW decays by 1e-2 unless told)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4


@dataclass(frozen=True)
class VocoderOptimizer:
    """The JAX package's ``make_vocoder_optimizer``: optax's
    ``adamw(exponential_decay(learning_rate, decay_every, lr_decay), b1,
    b2)`` with its defaults (eps 1e-8, weight decay 1e-4 on every
    parameter).  The rate of an update is ``learning_rate ·
    lr_decay^(count / decay_every)``, continuous, where ``count`` is the
    number of updates before it (the first uses ``learning_rate``)."""
    learning_rate: float = 2e-4
    betas: tuple[float, float] = (0.8, 0.99)
    lr_decay: float = 0.999
    decay_every: int = 1000

    def lr(self, count: int) -> float:
        return self.learning_rate * self.lr_decay ** (count
                                                      / self.decay_every)

    def build(self, params) -> torch.optim.AdamW:
        """torch's AdamW decays ``p`` by ``lr·wd·p`` beside the Adam step,
        as optax's ``add_decayed_weights`` before ``scale_by_lr``."""
        return torch.optim.AdamW(params, lr=self.learning_rate,
                                 betas=self.betas, eps=ADAM_EPS,
                                 weight_decay=WEIGHT_DECAY)


@dataclass
class VocoderState:
    generator: torch.nn.Module            # mel (B, F, n_mels) → wav (B, S)
    discriminator: HiFiGANDiscriminator
    gen_tx: VocoderOptimizer
    disc_tx: VocoderOptimizer
    gen_opt: torch.optim.AdamW
    disc_opt: torch.optim.AdamW
    device: torch.device
    step: int = 0                     # GAN steps applied

    def apply(self, opt: torch.optim.AdamW, tx: VocoderOptimizer) -> None:
        opt.param_groups[0]["lr"] = tx.lr(self.step)
        opt.step()


def create_vocoder_state(generator: torch.nn.Module,
                         discriminator: HiFiGANDiscriminator,
                         gen_tx: VocoderOptimizer,
                         disc_tx: VocoderOptimizer,
                         device: str | torch.device | None = None
                         ) -> VocoderState:
    """Move both models to ``device`` (CUDA unless the caller asks for the
    CPU; raises without a card) in train mode, each with a fresh AdamW.  The
    models come initialised: the discriminator from its seed, the generator
    from its own initialiser or warm-started from a checkpoint."""
    device = resolve_device(device)
    generator = generator.to(device).train()
    discriminator = discriminator.to(device).train()
    return VocoderState(
        generator=generator, discriminator=discriminator, gen_tx=gen_tx,
        disc_tx=disc_tx, gen_opt=gen_tx.build(generator.parameters()),
        disc_opt=disc_tx.build(discriminator.parameters()), device=device)


def make_vocoder_train_step(mel_cfg: MelSpectrogramConfig,
                            mesh: Optional[Mesh] = None,
                            data_axis: str = "data") -> Callable:
    """``step(state, wavs (B, S), mels=None) → VocoderMetrics``, updating
    ``state`` in place; on a ``mesh`` ``wavs`` (and ``mels``) are the
    global batch and the metrics the global batch's.

    The input mel is ``fused_log_mel(wavs)`` unless ``mels`` (B, F, n_mels)
    is given (teacher-forced fine-tuning).  The discriminator is updated
    first (real with ``update_stats=True``, then fake with the new
    statistics), then the generator against the new discriminator.  Each
    tree's gradient of its update is left in its parameters' ``.grad``.
    Under a profiler the three parts are the spans ``tts.gan.input_mel``,
    ``tts.gan.d_update`` and ``tts.gan.g_update`` (``tracing.span``), which
    a trace reads as the step's phases."""

    group = None if mesh is None else mesh.group(data_axis)
    rows = None if group is None else batch_sharding(mesh, data_axis)
    # each rank's losses are means over its rows: the gradients average
    # over every rank (data shards and replicas alike)
    divisor = None if mesh is None else mesh.size

    def step(state: VocoderState, wavs: torch.Tensor,
             mels: Optional[torch.Tensor] = None) -> VocoderMetrics:
        gen, disc = state.generator, state.discriminator
        if rows is not None:
            wavs = rows(wavs)
            mels = None if mels is None else rows(mels)
        with span("gan.input_mel"):
            wavs = wavs.to(state.device).contiguous()
            if mels is None:
                mel_in, _ = fused_log_mel(wavs, mel_cfg)  # (B, n_mels, F)
                mel_in = mel_in.transpose(1, 2)           # (B, F, n_mels)
            else:
                mel_in = mels.to(state.device)

        # --- discriminator update (generator frozen) ---------------------
        with span("gan.d_update"):
            with torch.no_grad():
                fake = gen(mel_in)
            # the centred STFT yields one extra frame, so F·hop can exceed
            # the segment: cut both sides to the common length
            n = min(fake.shape[1], wavs.shape[1])
            fake, real = fake[:, :n], wavs[:, :n]
            disc.zero_grad(set_to_none=True)
            mpd_r, msd_r = disc(real, update_stats=True)
            mpd_f, msd_f = disc(fake, update_stats=False)
            d_loss = (discriminator_loss(mpd_r, mpd_f)
                      + discriminator_loss(msd_r, msd_f))
            d_loss.backward()
            reduce_over_mesh(mesh, disc.parameters(), divisor)
            state.apply(state.disc_opt, state.disc_tx)

        # --- generator update (discriminator frozen) ---------------------
        with span("gan.g_update"):
            gen.zero_grad(set_to_none=True)
            wav_hat = gen(mel_in)[:, :n]
            with torch.no_grad():
                mpd_r, msd_r = disc(real)
            mpd_f, msd_f = disc(wav_hat)
            adv = (generator_adversarial_loss(mpd_f)
                   + generator_adversarial_loss(msd_f))
            fm = FM_WEIGHT * (feature_matching_loss(mpd_r, mpd_f)
                              + feature_matching_loss(msd_r, msd_f))
            mel = MEL_WEIGHT * mel_l1_loss(wav_hat, real, mel_cfg)
            total = adv + fm + mel
            total.backward(inputs=list(gen.parameters()))
            reduce_over_mesh(mesh, gen.parameters(), divisor)
            state.apply(state.gen_opt, state.gen_tx)

        state.step += 1
        metrics = torch.stack([t.detach() for t in (d_loss, adv, fm, mel,
                                                    total)])
        if group is not None:
            metrics = all_reduce(metrics, group) / dist.get_world_size(group)
        return VocoderMetrics(*metrics)

    return step


def sample_segments(wavs: list[np.ndarray], batch_size: int,
                    segment_size: int, rng: np.random.Generator
                    ) -> np.ndarray:
    """A random fixed-size segment batch drawn on the host; short clips are
    zero-padded.  The same draws as the JAX package's for the same
    ``rng``."""
    out = np.zeros((batch_size, segment_size), np.float32)
    idx = rng.integers(0, len(wavs), size=batch_size)
    for j, i in enumerate(idx):
        w = wavs[i]
        if len(w) > segment_size:
            s = rng.integers(0, len(w) - segment_size)
            out[j] = w[s: s + segment_size]
        else:
            out[j, : len(w)] = w
    return out
