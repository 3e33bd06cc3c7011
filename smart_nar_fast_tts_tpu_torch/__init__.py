"""PyTorch/CUDA port of ``smart_nar_fast_tts_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here is held
against its JAX counterpart by the ``tests/test_torch_*.py`` parity tests.
This package imports ``torch`` and numpy only; it never imports JAX, flax or
the JAX package.

What is ported so far is the serving path that ``bench.py`` times: token ids
→ ``FastSpeech2Align`` inference → HiFi-GAN V1 → waveform, through two CUDA
kernels written by hand for ``sm_90a`` (``csrc/``):

    config     — the configuration fields the serving path reads
    ops        — masks, positional table, hard and dense Gaussian upsampling
    kernels    — flash attention and banded Gaussian upsampling: CUDA kernels
                 with their plain PyTorch versions, and the nvcc build
    models     — FFT blocks, encoders, variance adaptor, FastSpeech2Align
    vocoder    — HiFi-GAN V1 generator
    weights    — the committed ``.npz`` checkpoints → PyTorch state dicts
    serving    — ``Synthesizer``: two-stage bucketed text → mel → waveform

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
