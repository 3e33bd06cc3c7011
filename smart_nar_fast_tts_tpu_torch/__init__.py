"""PyTorch/CUDA port of ``smart_nar_fast_tts_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here is held
against its JAX counterpart by the ``tests/test_torch_*.py`` parity tests.
This package imports ``torch`` and numpy only; it never imports JAX, flax or
the JAX package.

What is ported so far: text → waveform through the synthesize CLI
(``python -m smart_nar_fast_tts_tpu_torch.cli.synthesize``, with
``--stream_chunk`` for the streaming vocoder), serving synthesis (token
ids → ``FastSpeech2Align`` inference → HiFi-GAN V1 or V3, Vocos or MelGAN →
waveform, in f32 or under the bf16 compute policy), exported serving artifacts
(``cli.export``, ``serving.ExportedTTS``), the acoustic model's fit loop and
the vocoder's GAN training through the ``train``, ``evaluate`` and
``train_vocoder`` CLIs, corpus preprocessing (``cli.preprocess``), the
import of a reference checkpoint (``cli.import_checkpoint``) and the G2P
trainer (``cli.train_g2p``), and the multi-device axes (data parallelism,
ring sequence parallelism and the channel-sharded HiFi-GAN, one process
per card under torchrun), through
CUDA kernels written by hand for ``sm_90a`` (``csrc/``), one
for each Pallas kernel of the JAX package, with second kernels for the
widths the first ones do not take:

    config     — the configuration dataclasses and the YAML-triplet loaders
    yaml_subset — the reader of the YAML the configuration files use
    text       — the text frontend: symbols, cleaners, numbers, cmudict,
                 G2P (a copy of the JAX package's, numpy only)
    ops        — masks, positional table, hard and dense Gaussian upsampling,
                 duration extraction
    kernels    — flash attention, banded Gaussian upsampling, alignment
                 attention and fused STFT → log-mel: CUDA kernels with their
                 plain PyTorch versions, and the nvcc build; the serving
                 kernels' forwards are registered operators
                 (``smart_tts::flash_attention``,
                 ``smart_tts::gaussian_upsample_banded``)
    audio      — the mel filterbank, the STFT → log-mel front end, the
                 inverse STFT (by FFT and by matrix products) and
                 Griffin-Lim
    models     — FFT blocks, encoders, variance adaptor, FastSpeech2Align,
                 losses, reference state dicts ↔ the port's
    vocoder    — HiFi-GAN V1 and V3, Vocos and MelGAN generators, the
                 streaming vocoder, the discriminators and GAN losses, the
                 loaders of torch checkpoints and of the JAX package's
                 flax ``.msgpack`` files, the channel-sharded HiFi-GAN
    training   — the acoustic train and eval steps, the fit loop
                 (``Trainer``), validation, the vocoder GAN step, the port's
                 checkpoints, TensorBoard event files and figures written
                 without tensorboard, the profiler window
    data       — the training batch, the bucketed corpus pipeline,
                 synthesis metadata items, wav IO
    weights    — the committed ``.npz`` checkpoints and JAX trees → PyTorch
                 state dicts
    parallel   — the device mesh over ``torch.distributed`` (one process
                 per card), batch rows per rank, and ring attention over
                 the frame axis
    serving    — ``Synthesizer``: two-stage bucketed text → mel → waveform;
                 ``export_serving_artifacts`` and ``ExportedTTS``:
                 ``torch.export`` programs with the weights stored once
    cli        — ``synthesize``, ``export``, ``train``, ``evaluate``,
                 ``train_vocoder``, ``preprocess``, ``import_checkpoint``,
                 ``train_g2p``: the JAX package's CLIs, on the card

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
