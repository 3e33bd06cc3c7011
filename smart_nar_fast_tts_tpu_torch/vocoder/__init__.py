"""Vocoders of the serving path."""

from .hifigan import HiFiGANConfig, HiFiGANGenerator

__all__ = ["HiFiGANConfig", "HiFiGANGenerator"]
