"""FastSpeech2Align: TxtEncoder → (speaker embedding) → VarianceAdaptor →
MelDecoder → mel_linear → PostNet residual.

Training (ground-truth ``mels`` and ``mel_lens`` given): the MelEncoder
aligns the text with the mels; duration targets come from its last layer's
detached attention; ground-truth pitch and energy drive the variance
embeddings and the duration targets drive the upsampling.  With
``duration_extraction="intended"`` and ``duration_head_reduce="first"`` the
MelEncoder runs the alignment kernel, which returns only head 0's per-frame
argmax and guided-attention numerator; otherwise it keeps the full maps.
Inference: predicted durations drive the upsampling.

``sp_mesh`` runs the MelDecoder's self-attention as ring attention under
``ModelConfig.sequence_parallel``.  ``data_group``, the process group of
the data axis when each rank holds its rows of the batch, makes the
batch-level quantities the whole batch's: the text and frame capacities
(the longest item over the group) and the PostNet's BatchNorm statistics.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import FeatureStats, ModelConfig, PreprocessConfig
from ..ops.duration import durations_from_argmax, durations_from_attention
from ..ops.masks import length_to_valid
from ..parallel import all_reduce
from ..tracing import span
from .encoders import MelDecoder, MelEncoder, TxtEncoder
from .layers import PostNet, zero_where_not
from .variance import VarianceAdaptor


class ModelOutput(NamedTuple):
    mel: torch.Tensor                      # (B, T, n_mels) pre-postnet
    postnet_mel: torch.Tensor              # (B, T, n_mels)
    pitch_prediction: torch.Tensor
    energy_prediction: torch.Tensor
    log_duration_prediction: torch.Tensor  # (B, L)
    duration_rounded: torch.Tensor         # (B, L)
    src_valid: torch.Tensor                # (B, L) True = real
    mel_valid: torch.Tensor                # (B, T)
    src_lens: torch.Tensor                 # (B,)
    mel_lens: torch.Tensor                 # (B,) int32
    # training only
    alignments: Optional[torch.Tensor] = None         # (layers, B, H, T, L)
    duration_targets: Optional[torch.Tensor] = None   # (B, L) int32
    # training on the alignment kernel's path (alignments is None then):
    # head 0's Σ W·p over the valid pairs, per layer and item (layers, B)
    guided_numerators: Optional[torch.Tensor] = None


def _longest(lens: torch.Tensor, group) -> torch.Tensor:
    """The largest length of the batch, over ``group``'s rows too."""
    return all_reduce(lens.max(), group, torch.distributed.ReduceOp.MAX)


class FastSpeech2Align(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 preprocess_cfg: PreprocessConfig = PreprocessConfig()):
        super().__init__()
        self.cfg = cfg
        stats = preprocess_cfg.stats or FeatureStats()
        self.txt_encoder = TxtEncoder(cfg)
        self.mel_encoder = MelEncoder(cfg)
        if cfg.multi_speaker:
            self.speaker_emb = nn.Embedding(cfg.n_speakers,
                                            cfg.transformer.encoder_hidden)
        self.variance_adaptor = VarianceAdaptor(
            cfg, stats, pitch_feature_level=preprocess_cfg.pitch_feature,
            energy_feature_level=preprocess_cfg.energy_feature)
        self.mel_decoder = MelDecoder(cfg)
        self.mel_linear = nn.Linear(cfg.transformer.decoder_hidden,
                                    cfg.n_mel_channels)
        self.postnet = PostNet(n_mels=cfg.n_mel_channels)

    def forward(self, texts: torch.Tensor, src_lens: torch.Tensor,
                max_mel_len: Optional[int] = None,
                speakers: Optional[torch.Tensor] = None,
                p_control: float = 1.0, e_control: float = 1.0,
                d_control: float = 1.0,
                mels: Optional[torch.Tensor] = None,
                mel_lens: Optional[torch.Tensor] = None,
                p_targets: Optional[torch.Tensor] = None,
                e_targets: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sp_mesh=None, data_group=None) -> ModelOutput:
        """texts (B, L) symbol ids, src_lens (B,).  Inference: outputs at
        the static frame capacity ``max_mel_len`` (default
        ``cfg.max_seq_len``).  Training: ``mels`` (B, T, n_mels),
        ``mel_lens`` (B,) and the pitch and energy targets; outputs at T
        frames.  ``generator`` turns dropout on."""
        is_training = mels is not None and mel_lens is not None
        B, L = texts.shape
        src_valid = length_to_valid(src_lens, L)
        # batch-level capacity: the reference's tensors end at the longest
        # item, so its convs see zero padding there
        src_cap = torch.arange(L, device=texts.device) < _longest(
            src_lens, data_group)

        with span("acoustic.text_encoder"):
            src_output = self.txt_encoder(texts, src_valid, src_cap,
                                          generator)
        if self.cfg.multi_speaker and speakers is not None:
            src_output = src_output + self.speaker_emb(speakers)[:, None, :]

        alignments = guided_nums = d_targets = None
        mel_valid = mel_cap = None
        if is_training:
            T = mels.shape[1]
            mel_valid = length_to_valid(mel_lens, T)
            mel_cap = torch.arange(T, device=mels.device) < _longest(
                mel_lens, data_group)
            # the kernel implements exactly the intended/head-0 semantics
            fused = (self.cfg.duration_extraction == "intended"
                     and self.cfg.duration_head_reduce == "first")
            with span("acoustic.mel_encoder"):
                _, attns = self.mel_encoder(src_output, mels, src_valid,
                                            mel_valid, mel_cap, src_lens,
                                            mel_lens, fused, generator)
                if fused:
                    guided_nums = torch.stack([a["guided_num"]
                                               for a in attns])
                    d_targets = durations_from_argmax(
                        attns[-1]["argmax"].detach(), src_lens, mel_lens, L)
                else:
                    alignments = torch.stack(attns)
                    d_targets = durations_from_attention(
                        alignments[-1].detach(), src_lens, mel_lens,
                        mode=self.cfg.duration_extraction,
                        head_reduce=self.cfg.duration_head_reduce)
            max_len = T
        else:
            max_len = max_mel_len if max_mel_len is not None \
                else self.cfg.max_seq_len

        with span("acoustic.variance"):
            va = self.variance_adaptor(
                src_output, src_valid, max_len, mel_valid=mel_valid,
                pitch_target=p_targets, energy_target=e_targets,
                duration_target=d_targets, p_control=p_control,
                e_control=e_control, d_control=d_control, src_cap=src_cap,
                mel_cap=mel_cap, generator=generator)

        with span("acoustic.decoder"):
            x = self.mel_decoder(va.x, va.mel_valid, va.mel_cap, generator,
                                 sp_mesh)
            mel = self.mel_linear(x)
        with span("acoustic.postnet"):
            postnet_in = zero_where_not(va.mel_cap, mel)
            postnet_mel = self.postnet(postnet_in, va.mel_cap, generator,
                                       data_group) + mel
        return ModelOutput(
            mel=mel, postnet_mel=postnet_mel,
            pitch_prediction=va.pitch_prediction,
            energy_prediction=va.energy_prediction,
            log_duration_prediction=va.log_duration_prediction,
            duration_rounded=va.duration_rounded, src_valid=src_valid,
            mel_valid=va.mel_valid, src_lens=src_lens,
            mel_lens=mel_lens if is_training else va.mel_len,
            alignments=alignments, duration_targets=d_targets,
            guided_numerators=guided_nums)
