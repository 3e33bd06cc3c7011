"""Reference (PyTorch) checkpoints ↔ the port's ``FastSpeech2Align``.

The counterpart of ``smart_nar_fast_tts_tpu/models/convert.py``.  The port's
modules keep the reference's names (``txt_encoder.layer_stack.{i}.slf_attn.
w_qs``, ``postnet.convolutions.{i}.1.running_mean``, …) and layouts
(``nn.Linear``, ``nn.Conv1d``, ``nn.Embedding``, BatchNorm statistics as
buffers), so a reference ``FastSpeech2Align.state_dict()`` is the port's
state dict plus what the port regenerates from its config.  Converting is a
filter, not a relayout:

- :func:`reference_state_dict_to_port` stands for JAX's
  ``torch_state_dict_to_variables``: it drops the sinusoid ``*.position_enc``
  tables, ``variance_adaptor.{pitch,energy}_bins`` and the BatchNorm
  ``num_batches_tracked`` counters, and keeps ``speaker_emb.weight`` only
  for a multi-speaker config.  Every other key is kept, so a caller that
  compares the result with the model's keys sees what is missing or extra
  (``cli/import_checkpoint.py``).
- :func:`port_state_dict_to_reference` stands for JAX's
  ``variables_to_torch_state_dict``: the same keys and values, as numpy.
  Unlike JAX's, it also writes ``speaker_emb.weight`` for a multi-speaker
  config, which the reference model holds and JAX's inverse leaves out.
- :func:`reference_buffers` makes the dropped entries from a config (the
  reference computes them from the same formulas), for a state dict that a
  reference model loads strictly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..config import FeatureStats, ModelConfig, PreprocessConfig
from ..ops.positional import sinusoid_table
from ..weights import acoustic_rules
from .variance import quantization_bins

POSITIONAL = ("txt_encoder", "mel_encoder", "mel_decoder")
BINS = ("variance_adaptor.pitch_bins", "variance_adaptor.energy_bins")


def _regenerated(key: str, cfg: ModelConfig) -> bool:
    """Whether the port rebuilds ``key`` from its config (or, for the
    speaker table, has none)."""
    return (key.rsplit(".", 1)[-1] == "position_enc" or key in BINS
            or key.endswith(".num_batches_tracked")
            or (key == "speaker_emb.weight" and not cfg.multi_speaker))


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(value))


def reference_state_dict_to_port(sd: Mapping[str, object], cfg: ModelConfig
                                 ) -> dict[str, torch.Tensor]:
    """A reference state dict (numpy arrays or tensors) → the port's state
    dict (CPU tensors): the regenerated entries dropped, the rest kept."""
    return {k: _tensor(v) for k, v in sd.items() if not _regenerated(k, cfg)}


def port_state_dict_to_reference(sd: Mapping[str, torch.Tensor],
                                 cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The port's state dict → the reference's keys (those of JAX's
    ``variables_to_torch_state_dict``, and ``speaker_emb.weight`` for a
    multi-speaker config) as numpy arrays.  Raises ``KeyError`` for a key
    the config needs and ``sd`` lacks."""
    return {k: _tensor(sd[k]).numpy() for k in acoustic_rules(cfg)}


def reference_buffers(cfg: ModelConfig,
                      pre: PreprocessConfig = PreprocessConfig()
                      ) -> dict[str, np.ndarray]:
    """The entries a reference state dict holds beyond the port's: each
    stack's ``position_enc`` (1, max_seq_len + 1, hidden), the quantization
    bins of ``pre.stats`` and the five PostNet BatchNorms'
    ``num_batches_tracked`` (0)."""
    t = cfg.transformer
    stats = pre.stats or FeatureStats()
    ve = cfg.variance_embedding
    out = {}
    for name, d in zip(POSITIONAL, (t.encoder_hidden, t.decoder_hidden,
                                    t.decoder_hidden)):
        out[f"{name}.position_enc"] = sinusoid_table(cfg.max_seq_len + 1,
                                                     d)[None]
    out[BINS[0]] = quantization_bins(stats.pitch_min, stats.pitch_max,
                                     ve.n_bins,
                                     ve.pitch_quantization == "log")
    out[BINS[1]] = quantization_bins(stats.energy_min, stats.energy_max,
                                     ve.n_bins,
                                     ve.energy_quantization == "log")
    for i in range(5):
        out[f"postnet.convolutions.{i}.1.num_batches_tracked"] = np.asarray(
            0, np.int64)
    return out
