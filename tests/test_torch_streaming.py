"""The port's streaming vocoder (``vocoder/streaming.py``) against the JAX
package's, on the CPU.

- The receptive-field halos equal JAX's for HiFi-GAN V1 and V3 and for the
  JAX MelGAN and Vocos configs, read by attribute.
- ``StreamingVocoder`` on a seeded two-stage generator (weights shared with
  the JAX generator through ``jax_to_torch_hifigan``) and on V1's rates
  with narrow channels: ``synthesize_chunks``, the online ``stream`` fed in
  pieces of 1, 7 and 64 frames, and an utterance shorter than one window
  equal the port's full forward within 1e-6 (the bar of JAX's
  ``tests/test_streaming_vocoder.py``), and each chunk equals JAX's
  ``StreamingVocoder``'s within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_nar_fast_tts_tpu.vocoder import HiFiGANConfig as JaxConfig
from smart_nar_fast_tts_tpu.vocoder import HiFiGANGenerator as JaxGenerator
from smart_nar_fast_tts_tpu.vocoder import StreamingVocoder as JaxStreaming
from smart_nar_fast_tts_tpu.vocoder import MelGANConfig, VocosConfig
from smart_nar_fast_tts_tpu.vocoder import streaming as jax_streaming
from smart_nar_fast_tts_tpu_torch.vocoder import (HiFiGANConfig,
                                                  HiFiGANGenerator,
                                                  StreamingVocoder,
                                                  receptive_halo)
from smart_nar_fast_tts_tpu_torch.vocoder import streaming
from smart_nar_fast_tts_tpu_torch.weights import jax_to_torch_hifigan
from torch_port_util import (flatten, one_torch_thread,  # noqa: F401
                             random_variables)

FULL_ATOL = 1e-6     # chunks against the port's own full forward
JAX_ATOL = 1e-5      # chunks against JAX's chunks

V3 = dict(resblock="2", upsample_rates=(8, 8, 4),
          upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=256,
          resblock_kernel_sizes=(3, 5, 7),
          resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))
TINY = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
            upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 2), (1, 2)), n_mels=8)
V1_SLIM = dict(upsample_initial_channel=16, n_mels=8)


@pytest.mark.parametrize("name, jax_config, expect", [
    ("V1", JaxConfig(), 14),
    ("V3", JaxConfig(**V3), 12),
    ("tiny", JaxConfig(**TINY), None),
    ("MelGAN", MelGANConfig(), None),
    ("MelGAN 2 layers", MelGANConfig(n_residual_layers=2, ratios=(8, 4, 4)),
     None),
    ("Vocos", VocosConfig(), None),
    ("Vocos narrow", VocosConfig(n_layers=2, n_fft=64, hop=16, dw_kernel=5),
     None)])
def test_halo_equals_jax(name, jax_config, expect):
    halo = receptive_halo(jax_config)
    assert halo == jax_streaming.receptive_halo(jax_config)
    if expect is not None:
        assert halo == expect
    if hasattr(jax_config, "upsample_rates"):
        port = HiFiGANConfig.from_dict(jax_config.to_dict())
        assert streaming.mel_receptive_halo(port) == halo


def _pair(kw, seed):
    """The JAX generator and variables and the port's generator with the
    same weights."""
    jax_gen = JaxGenerator(JaxConfig(**kw, tail_impl="plain"))
    shapes = jax.eval_shape(lambda: jax_gen.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, kw["n_mels"]))))
    variables = random_variables(shapes, seed)
    config = HiFiGANConfig(**kw)
    gen = HiFiGANGenerator(config)
    gen.load_state_dict(jax_to_torch_hifigan(flatten(variables), config))
    return jax_gen, variables, gen.eval()


@pytest.fixture(scope="module", params=["tiny", "v1-topology"])
def pair(request):
    kw = TINY if request.param == "tiny" else V1_SLIM
    return _pair(kw, seed=len(request.param))


def _full(gen, mel):
    with torch.no_grad():
        return gen(torch.from_numpy(mel[None]))[0].numpy()


def _mel(T, n_mels, seed):
    return np.random.RandomState(seed).randn(T, n_mels).astype(np.float32)


@pytest.mark.parametrize("chunk", [3, 16])
def test_chunks_equal_full_forward_and_jax(pair, chunk):
    jax_gen, variables, gen = pair
    sv = StreamingVocoder(gen, chunk_frames=chunk)
    jsv = JaxStreaming(jax_gen, variables, chunk_frames=chunk)
    assert (sv.halo, sv.window_frames) == (jsv.halo, jsv.window_frames)
    # an exact multiple of the chunk past one window, and a ragged tail
    for T in (sv.window_frames + 2 * chunk,
              sv.window_frames + 2 * chunk + chunk // 2 + 1):
        mel = _mel(T, gen.config.n_mels, T)
        chunks = list(sv.synthesize_chunks(mel))
        expect = list(jsv.synthesize_chunks(mel))
        assert [c.shape for c in chunks] == [c.shape for c in expect]
        for got, want in zip(chunks, expect):
            np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=0)
        for c in chunks[:-1]:
            assert c.shape == (chunk * sv.hop,)
        np.testing.assert_allclose(np.concatenate(chunks), _full(gen, mel),
                                   atol=FULL_ATOL, rtol=0)


@pytest.mark.parametrize("piece", [1, 7, 64])
def test_online_stream_equals_full_forward(pair, piece):
    _, _, gen = pair
    sv = StreamingVocoder(gen, chunk_frames=16)
    T = 3 * sv.window_frames + 5
    mel = _mel(T, gen.config.n_mels, 40 + piece)
    out = list(sv.stream(mel[i:i + piece] for i in range(0, T, piece)))
    np.testing.assert_allclose(np.concatenate(out), _full(gen, mel),
                               atol=FULL_ATOL, rtol=0)
    np.testing.assert_allclose(np.concatenate(out), sv.synthesize(mel),
                               atol=FULL_ATOL, rtol=0)
    # the buffer holds about one window and a chunk, not the utterance
    assert sv.buffered_frames_high_water <= (sv.window_frames
                                             + sv.chunk_frames + piece)
    assert sv.buffered_frames_high_water < T


def test_short_utterance_is_one_forward(pair):
    jax_gen, variables, gen = pair
    sv = StreamingVocoder(gen, chunk_frames=16)
    jsv = JaxStreaming(jax_gen, variables, chunk_frames=16)
    mel = _mel(sv.window_frames - 3, gen.config.n_mels, 7)
    chunks = list(sv.synthesize_chunks(mel))
    assert len(chunks) == 1
    np.testing.assert_allclose(chunks[0], _full(gen, mel), atol=FULL_ATOL,
                               rtol=0)
    np.testing.assert_allclose(chunks[0], jsv.synthesize(mel),
                               atol=JAX_ATOL, rtol=0)
    streamed = np.concatenate(list(sv.stream([mel[:5], mel[5:]])))
    np.testing.assert_allclose(streamed, chunks[0], atol=FULL_ATOL, rtol=0)
    assert list(sv.synthesize_chunks(mel[:0])) == []


def test_chunk_frames_must_be_positive(pair):
    with pytest.raises(ValueError, match="chunk_frames"):
        StreamingVocoder(pair[2], chunk_frames=0)
