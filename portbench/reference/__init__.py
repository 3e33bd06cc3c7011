"""Plain PyTorch references of the benchmark's configurations.

Written from the published architectures and the semantics the port
documents (masking at the batch's longest item, the Gaussian length
regulator, post-LN FFT blocks, HiFi-GAN V1, Vocos with an inverse STFT).
They import nothing of the port and no JAX: each takes a dict of weights
by the port's state-dict names, which the benchmark makes from the seed and
hands to both sides.  Every product is float32 unless the configuration
states otherwise (self-attention past ``attention_bf16_past`` frames
rounds its operands to bfloat16, as the configuration states).
"""
