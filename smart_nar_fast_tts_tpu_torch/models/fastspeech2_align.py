"""FastSpeech2Align inference: TxtEncoder → (speaker embedding) →
VarianceAdaptor → MelDecoder → mel_linear → PostNet residual.

The training path (MelEncoder alignment, duration extraction, losses) waits
for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import FeatureStats, ModelConfig, PreprocessConfig
from ..ops.masks import length_to_valid
from .encoders import MelDecoder, TxtEncoder
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


class FastSpeech2Align(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 preprocess_cfg: PreprocessConfig = PreprocessConfig()):
        super().__init__()
        self.cfg = cfg
        stats = preprocess_cfg.stats or FeatureStats()
        self.txt_encoder = TxtEncoder(cfg)
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
                d_control: float = 1.0) -> ModelOutput:
        """texts (B, L) symbol ids, src_lens (B,) → outputs at the static
        frame capacity ``max_mel_len`` (default ``cfg.max_seq_len``)."""
        B, L = texts.shape
        src_valid = length_to_valid(src_lens, L)
        # batch-level capacity: the reference's tensors end at the longest
        # item, so its convs see zero padding there
        src_cap = torch.arange(L, device=texts.device) < src_lens.max()

        src_output = self.txt_encoder(texts, src_valid, src_cap)
        if self.cfg.multi_speaker and speakers is not None:
            src_output = src_output + self.speaker_emb(speakers)[:, None, :]

        max_len = max_mel_len if max_mel_len is not None \
            else self.cfg.max_seq_len
        va = self.variance_adaptor(
            src_output, src_valid, max_len, p_control=p_control,
            e_control=e_control, d_control=d_control, src_cap=src_cap)

        x = self.mel_decoder(va.x, va.mel_valid, va.mel_cap)
        mel = self.mel_linear(x)
        postnet_in = zero_where_not(va.mel_cap, mel)
        postnet_mel = self.postnet(postnet_in, va.mel_cap) + mel
        return ModelOutput(
            mel=mel, postnet_mel=postnet_mel,
            pitch_prediction=va.pitch_prediction,
            energy_prediction=va.energy_prediction,
            log_duration_prediction=va.log_duration_prediction,
            duration_rounded=va.duration_rounded, src_valid=src_valid,
            mel_valid=va.mel_valid, src_lens=src_lens, mel_lens=va.mel_len)
