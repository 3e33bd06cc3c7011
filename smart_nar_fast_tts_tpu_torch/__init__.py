"""PyTorch/CUDA port of ``smart_nar_fast_tts_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here is held
against its JAX counterpart by the ``tests/test_torch_*.py`` parity tests.
This package imports ``torch`` and numpy only; it never imports JAX, flax or
the JAX package.

What is ported so far: serving synthesis (token ids → ``FastSpeech2Align``
inference → HiFi-GAN V1 → waveform), the acoustic model's train step and
the vocoder's GAN train step, through four CUDA kernels written by hand for
``sm_90a`` (``csrc/``), one for each Pallas kernel of the JAX package:

    config     — the configuration fields the ported paths read
    ops        — masks, positional table, hard and dense Gaussian upsampling,
                 duration extraction
    kernels    — flash attention, banded Gaussian upsampling, alignment
                 attention and fused STFT → log-mel: CUDA kernels with their
                 plain PyTorch versions, and the nvcc build
    audio      — the mel filterbank and the STFT → log-mel front end
    models     — FFT blocks, encoders, variance adaptor, FastSpeech2Align,
                 losses
    vocoder    — HiFi-GAN V1 generator, its discriminators and GAN losses
    training   — the acoustic train and eval steps, the vocoder GAN step
    data       — the training batch
    weights    — the committed ``.npz`` checkpoints and JAX trees → PyTorch
                 state dicts
    serving    — ``Synthesizer``: two-stage bucketed text → mel → waveform

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
