"""HiFi-GAN: the V1 and V3 generators, the streaming vocoder, the
discriminators and losses of GAN training, and the loader of upstream torch
checkpoints."""

from .convert import fold_weight_norm, load_hifigan, load_vocoder
from .discriminators import HiFiGANDiscriminator
from .hifigan import HiFiGANConfig, HiFiGANGenerator
from .streaming import (StreamingVocoder, mel_receptive_halo,
                        melgan_receptive_halo, receptive_halo,
                        vocos_receptive_halo)

__all__ = ["HiFiGANConfig", "HiFiGANDiscriminator", "HiFiGANGenerator",
           "StreamingVocoder", "fold_weight_norm", "load_hifigan",
           "load_vocoder", "mel_receptive_halo", "melgan_receptive_halo",
           "receptive_halo", "vocos_receptive_halo"]
