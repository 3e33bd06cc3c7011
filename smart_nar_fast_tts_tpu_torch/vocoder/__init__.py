"""Neural vocoders (mel → waveform): the HiFi-GAN V1 and V3, Vocos and
MelGAN generators, the streaming vocoder, the discriminators and losses of
GAN training, and the loaders of torch checkpoints and of the JAX package's
flax ``.msgpack`` files, and the channel-sharded HiFi-GAN over a mesh."""

from .convert import (fold_weight_norm, load_hifigan, load_melgan,
                      load_vocoder)
from .discriminators import HiFiGANDiscriminator
from .hifigan import HiFiGANConfig, HiFiGANGenerator
from .melgan import MelGANConfig, MelGANGenerator, melgan_inverse
from .msgpack import read_flax_msgpack
from .sharding import hifigan_pspecs, shard_hifigan
from .streaming import (StreamingVocoder, mel_receptive_halo,
                        melgan_receptive_halo, receptive_halo,
                        vocos_receptive_halo)
from .vocos import ConvNeXtBlock1d, VocosConfig, VocosGenerator, vocos_infer

__all__ = ["ConvNeXtBlock1d", "HiFiGANConfig", "HiFiGANDiscriminator",
           "HiFiGANGenerator", "MelGANConfig", "MelGANGenerator",
           "StreamingVocoder", "VocosConfig", "VocosGenerator",
           "fold_weight_norm", "hifigan_pspecs", "load_hifigan",
           "load_melgan", "load_vocoder", "mel_receptive_halo",
           "melgan_inverse", "melgan_receptive_halo", "read_flax_msgpack",
           "receptive_halo", "shard_hifigan", "vocos_infer",
           "vocos_receptive_halo"]
