"""Text encoder and mel decoder: sinusoid PE + N self-attention FFT blocks.

The PE table extends past ``max_seq_len`` from the same formula, as the JAX
package generates it per traced length.  The mel encoder and prenet (the
alignment path of training) wait for the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import VOCAB_SIZE, ModelConfig
from ..ops.positional import sinusoid_table
from .layers import FFTBlock


class _PositionalStack(nn.Module):
    """A stack of FFT blocks over input + PE; the PE rows up to
    ``max_seq_len`` are kept as a (non-checkpoint) buffer."""

    def __init__(self, d_model: int, n_layers: int, n_head: int,
                 cfg: ModelConfig):
        super().__init__()
        t = cfg.transformer
        self.d_model = d_model
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_table(cfg.max_seq_len + 1,
                                                  d_model)),
            persistent=False)
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, n_head, t.conv_filter_size, t.conv_kernel_size)
            for _ in range(n_layers))

    def positional(self, length: int) -> torch.Tensor:
        if length <= self.pe.shape[0]:
            return self.pe[:length]
        return torch.from_numpy(sinusoid_table(length, self.d_model)).to(
            self.pe.device)

    def run_stack(self, x: torch.Tensor, valid: torch.Tensor,
                  cap_valid: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.positional(x.shape[1])[None]
        for layer in self.layer_stack:
            x = layer(x, valid, cap_valid)
        return x


class TxtEncoder(_PositionalStack):
    """Phoneme embedding + PE + FFT blocks."""

    def __init__(self, cfg: ModelConfig):
        t = cfg.transformer
        super().__init__(t.encoder_hidden, t.encoder_layer, t.encoder_head,
                         cfg)
        self.src_word_emb = nn.Embedding(VOCAB_SIZE, t.encoder_hidden)

    def forward(self, texts: torch.Tensor, src_valid: torch.Tensor,
                src_cap: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.run_stack(self.src_word_emb(texts), src_valid, src_cap)


class MelDecoder(_PositionalStack):
    """PE + FFT blocks over the upsampled frame sequence."""

    def __init__(self, cfg: ModelConfig):
        t = cfg.transformer
        super().__init__(t.decoder_hidden, t.decoder_layer, t.decoder_head,
                         cfg)

    def forward(self, x: torch.Tensor, mel_valid: torch.Tensor,
                mel_cap: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.run_stack(x, mel_valid, mel_cap)
