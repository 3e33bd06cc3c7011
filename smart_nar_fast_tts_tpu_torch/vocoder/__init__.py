"""HiFi-GAN: the V1 generator of the serving path, and the discriminators
and losses of its GAN training."""

from .discriminators import HiFiGANDiscriminator
from .hifigan import HiFiGANConfig, HiFiGANGenerator

__all__ = ["HiFiGANConfig", "HiFiGANDiscriminator", "HiFiGANGenerator"]
