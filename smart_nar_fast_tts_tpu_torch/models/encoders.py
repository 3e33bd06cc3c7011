"""Text encoder, mel encoder and mel decoder: sinusoid PE + N FFT blocks.

The PE table extends past ``max_seq_len`` from the same formula, as the JAX
package generates it per traced length.  The MelEncoder (training only)
aligns text and mel: prenet-projected ground-truth mels, first frame zeroed,
attend over the text encoder's output through cross-attention FFT blocks;
its attention maps (or, on the alignment kernel's path, their reductions)
give the duration targets and the guided-attention loss.

Under ``compute_dtype="bfloat16"`` (DESIGN.md §4) the text encoder and the
mel decoder compute in bf16 and return f32; the MelEncoder stays f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import VOCAB_SIZE, ModelConfig
from ..ops.positional import sinusoid_rows, sinusoid_table
from .layers import FFTBlock, Prenet


class _PositionalStack(nn.Module):
    """A stack of FFT blocks over input + PE; the PE rows up to
    ``max_seq_len`` are kept as a (non-checkpoint) buffer."""

    def __init__(self, d_model: int, n_layers: int, n_head: int,
                 dropout_rate: float, cfg: ModelConfig, cross: bool = False):
        super().__init__()
        t = cfg.transformer
        self.d_model = d_model
        # the MelEncoder (alignment) stays f32 under the bf16 policy
        self.dtype = torch.float32 if cross else getattr(torch,
                                                          cfg.compute_dtype)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoid_table(cfg.max_seq_len + 1,
                                                  d_model)),
            persistent=False)
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, n_head, t.conv_filter_size, t.conv_kernel_size,
                     dropout_rate, cross=cross,
                     guided_sigma=cfg.guided_sigma)
            for _ in range(n_layers))

    def positional(self, length: int) -> torch.Tensor:
        """The first ``length`` PE rows; past the buffer, computed on its
        device (an exported program then holds no table of its own)."""
        if length <= self.pe.shape[0]:
            return self.pe[:length]
        return sinusoid_rows(length, self.d_model, self.pe.device)

    def run_stack(self, x: torch.Tensor, valid: torch.Tensor,
                  cap_valid: Optional[torch.Tensor],
                  generator: Optional[torch.Generator],
                  sp_mesh=None, sp_axis: str = "data") -> torch.Tensor:
        """The stack in ``compute_dtype`` (PE added in it too); returns
        f32, where the variance adaptor and mel_linear take it."""
        x = x.to(self.dtype)
        x = x + self.positional(x.shape[1]).to(self.dtype)[None]
        for layer in self.layer_stack:
            x, _ = layer(x, valid, cap_valid, generator=generator,
                         sp_mesh=sp_mesh, sp_axis=sp_axis)
        return x.float()


class TxtEncoder(_PositionalStack):
    """Phoneme embedding + PE + FFT blocks."""

    def __init__(self, cfg: ModelConfig):
        t = cfg.transformer
        super().__init__(t.encoder_hidden, t.encoder_layer, t.encoder_head,
                         t.encoder_dropout, cfg)
        self.src_word_emb = nn.Embedding(VOCAB_SIZE, t.encoder_hidden)

    def forward(self, texts: torch.Tensor, src_valid: torch.Tensor,
                src_cap: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.run_stack(self.src_word_emb(texts), src_valid, src_cap,
                              generator)


class MelEncoder(_PositionalStack):
    """Prenet(mels with the go frame zeroed) + PE, then cross-attention FFT
    blocks over the text encoder's output.

    Returns the last hidden state (which the model discards) and, per
    layer, the (B, H, T, L) attention maps, or with ``fused`` the alignment
    kernel's ``{"argmax", "guided_num"}`` of head 0."""

    def __init__(self, cfg: ModelConfig):
        t = cfg.transformer
        super().__init__(t.decoder_hidden, t.decoder_layer, t.decoder_head,
                         t.decoder_dropout, cfg, cross=True)
        self.prenet = Prenet(cfg.n_mel_channels, t.decoder_hidden)

    def forward(self, src_output: torch.Tensor, mels: torch.Tensor,
                src_valid: torch.Tensor, mel_valid: torch.Tensor,
                mel_cap: Optional[torch.Tensor], src_lens: torch.Tensor,
                mel_lens: torch.Tensor, fused: bool,
                generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, list]:
        frames = torch.arange(mels.shape[1], device=mels.device)
        go_mels = torch.where((frames > 0)[None, :, None], mels, 0.0)
        x = self.prenet(go_mels, generator)
        x = x + self.positional(mels.shape[1])[None]
        lens = (src_lens, mel_lens) if fused else None
        attns = []
        for layer in self.layer_stack:
            x, attn = layer(x, mel_valid, mel_cap, kv=src_output,
                            kv_valid=src_valid, lens=lens,
                            generator=generator)
            attns.append(attn)
        return x, attns


class MelDecoder(_PositionalStack):
    """PE + FFT blocks over the upsampled frame sequence.

    Under ``cfg.sequence_parallel`` each block's self-attention is ring
    attention with the frame axis split over ``cfg.sp_axis`` of
    ``sp_mesh``, which must then be given (``parallel/sequence.py``)."""

    def __init__(self, cfg: ModelConfig):
        t = cfg.transformer
        super().__init__(t.decoder_hidden, t.decoder_layer, t.decoder_head,
                         t.decoder_dropout, cfg)
        self.sequence_parallel = cfg.sequence_parallel
        self.sp_axis = cfg.sp_axis

    def forward(self, x: torch.Tensor, mel_valid: torch.Tensor,
                mel_cap: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sp_mesh=None) -> torch.Tensor:
        if self.sequence_parallel and sp_mesh is None:
            raise ValueError(
                "ModelConfig.sequence_parallel=True requires the mesh: "
                "pass sp_mesh= to the model call (a parallel.Mesh with "
                f"axis {self.sp_axis!r}; the frame capacity {x.shape[1]} "
                "must divide its size)")
        sp = sp_mesh if self.sequence_parallel else None
        return self.run_stack(x, mel_valid, mel_cap, generator, sp,
                              self.sp_axis)
