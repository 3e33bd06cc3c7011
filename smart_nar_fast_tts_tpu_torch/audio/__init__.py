"""Audio features: the numpy mel filterbank and window, and the STFT →
log-mel front end in PyTorch."""

from .stft import (MelSpectrogramConfig, frame_signal, mel_spectrogram,
                   stft_magnitude)

__all__ = ["MelSpectrogramConfig", "frame_signal", "mel_spectrogram",
           "stft_magnitude"]
