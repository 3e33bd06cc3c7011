"""HiFi-GAN: the V1 generator of the serving path, and the discriminators
and losses of its GAN training, and the loader of upstream torch
checkpoints."""

from .convert import fold_weight_norm, load_hifigan, load_vocoder
from .discriminators import HiFiGANDiscriminator
from .hifigan import HiFiGANConfig, HiFiGANGenerator

__all__ = ["HiFiGANConfig", "HiFiGANDiscriminator", "HiFiGANGenerator",
           "fold_weight_norm", "load_hifigan", "load_vocoder"]
