"""Audio features: the numpy mel filterbank and window, and the STFT →
log-mel front end in PyTorch, and the inverse STFT and Griffin-Lim."""

from .stft import (MelSpectrogramConfig, frame_signal, griffin_lim, istft,
                   mel_spectrogram, stft_magnitude)

__all__ = ["MelSpectrogramConfig", "frame_signal", "griffin_lim", "istft",
           "mel_spectrogram", "stft_magnitude"]
