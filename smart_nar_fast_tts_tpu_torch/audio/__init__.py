"""Audio features: the numpy mel filterbank and window, and the STFT →
log-mel front end in PyTorch, and the inverse STFT (by FFT and by
matrix products) and Griffin-Lim."""

from .stft import (MelSpectrogramConfig, frame_signal, griffin_lim, istft,
                   istft_matmul, mel_spectrogram, stft_magnitude)

__all__ = ["MelSpectrogramConfig", "frame_signal", "griffin_lim", "istft",
           "istft_matmul", "mel_spectrogram", "stft_magnitude"]
