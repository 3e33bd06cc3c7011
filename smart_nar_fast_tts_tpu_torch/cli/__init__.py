"""Command-line entry points of the port (``python -m
smart_nar_fast_tts_tpu_torch.cli.<name>``)."""
