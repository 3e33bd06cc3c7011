"""Command-line entry points of the port (``python -m
smart_nar_fast_tts_tpu_torch.cli.<name>``), one for each CLI of the JAX
package: ``synthesize``, ``export``, ``train``, ``evaluate``,
``train_vocoder``, ``preprocess``, ``import_checkpoint`` (a reference
``.pth.tar`` → the port's checkpoint) and ``train_g2p``."""
