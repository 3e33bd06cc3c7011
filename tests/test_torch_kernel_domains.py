"""The kernels' rules where they differ from the dense functions, checked on
the CPU: the upsampling kernel's tile rule and the zero-padding of the head
dim that the attention wrappers apply on the card.

- ``gaussian_upsample_tile_reference`` applies the upsampling kernel's tile
  rule (a phoneme whose center lies more than the band from a 32-frame tile
  is left out of it) in plain PyTorch.  At the kernel's band, √104·σ, it
  equals the dense ``ops.upsample.gaussian_upsample`` at F32_ATOL (1e-5, the
  card test's tolerance) on phonemes longer than 12σ, where the old 6σ band
  lost frames: a weight of up to exp(-36) was left out while the
  denominator's 1e-20 does not hide it.  The test asserts that the 6σ band
  misses there, so it is shown to see the fault.
- The flash and alignment wrappers zero-pad D to the tensor-core kernels'
  widths (flash: 64, 128, 192 or 256; alignment: a multiple of 4 up to
  256) with the scale of the true D.  The plain versions that round where
  the kernels do are held, on padded inputs with that scale, to themselves
  on the unpadded ones: zero columns add exact zeros, so what is left is the
  order of the CPU's f32 sums (1e-6).  Past 256 both wrappers route to the
  general kernel, checked here with the launchers stubbed.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from smart_nar_fast_tts_tpu_torch.kernels import (alignment_tf32x3_reference,
                                                  attention_bf16_reference)
from smart_nar_fast_tts_tpu_torch.kernels import _build
from smart_nar_fast_tts_tpu_torch.kernels import alignment as align_mod
from smart_nar_fast_tts_tpu_torch.kernels import attention as flash_mod
from smart_nar_fast_tts_tpu_torch.kernels.attention import padded_head_dim
from smart_nar_fast_tts_tpu_torch.kernels.upsample import (
    BAND_SIGMAS, gaussian_upsample_tile_reference)
from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample

F32_ATOL = 1e-5
PAD_ATOL = 1e-6
OLD_BAND = 6.0


def _upsample_case(durations, T, seed, D=16):
    rng = np.random.default_rng(seed)
    d = torch.tensor(durations, dtype=torch.float32)
    B, L = d.shape
    x = torch.from_numpy(rng.standard_normal((B, L, D)).astype(np.float32))
    return x, d, T, torch.ones(B, L)


def _gap(band_sigmas, x, d, T, valid):
    out, mel_len = gaussian_upsample_tile_reference(
        x, d, T, valid, band_sigmas=band_sigmas)
    e_out, e_len, _ = gaussian_upsample(x, d, T, valid)
    assert torch.equal(mel_len, e_len)
    return (out - e_out).abs().max().item()


def test_tile_rule_single_long_phoneme():
    """One phoneme of 132 frames at T 140: frames 128-131 lie 62-65 frames
    from its center, in a tile that the 6σ band leaves empty."""
    args = _upsample_case([[132]], 140, seed=0)
    assert _gap(BAND_SIGMAS, *args) <= F32_ATOL
    assert _gap(OLD_BAND, *args) > 1.0


def test_tile_rule_last_phoneme_sweep():
    """d = [7, 9, 4, 11, 6, d_last] for d_last 120-190, all in one batch:
    the 6σ band is off by more than 1e-3 at d_last 124-125 and 158-189."""
    rows = [[7, 9, 4, 11, 6, d_last] for d_last in range(120, 191)]
    args = _upsample_case(rows, 37 + 190 + 8, seed=1)
    assert _gap(BAND_SIGMAS, *args) <= F32_ATOL
    x, d, T, valid = args
    old, _ = gaussian_upsample_tile_reference(x, d, T, valid,
                                              band_sigmas=OLD_BAND)
    dense, _, _ = gaussian_upsample(x, d, T, valid)
    bad = (old - dense).abs().amax(dim=(1, 2)) > 1e-3
    assert bad[124 - 120] and bad[125 - 120] and bad[170 - 120]
    assert not bad[0]


def test_tile_rule_flagship_durations():
    """Flagship-like durations (d ≤ 20, L 128, ragged lengths) at T 1000:
    both bands agree with the dense function there."""
    rng = np.random.default_rng(2)
    d = rng.integers(0, 21, (4, 128)).astype(np.float32)
    x, d, T, valid = _upsample_case(d.tolist(), 1000, seed=3, D=32)
    valid[1, 100:] = 0.0
    assert _gap(BAND_SIGMAS, x, d, T, valid) <= F32_ATOL
    assert _gap(OLD_BAND, x, d, T, valid) <= F32_ATOL


@pytest.mark.parametrize("d, width", [(1, 64), (32, 64), (64, 64),
                                      (80, 128), (96, 128), (128, 128),
                                      (160, 192), (192, 192), (200, 256),
                                      (256, 256)])
def test_padded_head_dim(d, width):
    assert padded_head_dim(d) == width


class _Routed(Exception):
    """Raised by the stubbed launchers with the route taken."""


def _stub_routes(monkeypatch, module):
    """The wrapper module's launchers stubbed: the general kernel's raises
    ``_Routed("general")``, loading the tensor-core kernel's library raises
    ``_Routed("tensor cores", D)`` with the head dim it would launch."""
    def general(q, *args):
        raise _Routed("general", q.shape[-1])

    def load(stem, signatures):
        raise _Routed("tensor cores", stem)
    monkeypatch.setattr(module, "_launch_general", general)
    monkeypatch.setattr(_build, "load", load)


@pytest.mark.parametrize("D", [129, 160, 192, 200, 255, 256, 257, 320, 512])
def test_flash_route_by_head_dim(monkeypatch, D):
    """Up to 256 the flash wrapper launches the tensor-core kernel, past it
    the general one (its ``_launch`` called directly: on the CPU the wrapper
    takes the plain version)."""
    _stub_routes(monkeypatch, flash_mod)
    q = torch.zeros(1, 2, 5, D)
    valid = torch.ones(1, 5, dtype=torch.bool)
    with pytest.raises(_Routed) as routed:
        flash_mod._launch(q, q, q, valid)
    assert routed.value.args == (("general", D) if D > 256
                                 else ("tensor cores", "flash_attention"))


@pytest.mark.parametrize("D", [128, 150, 192, 256, 257, 320])
def test_alignment_route_by_head_dim(monkeypatch, D):
    """The same for the alignment wrapper: the tensor-core kernel up to 256,
    the general one past it."""
    _stub_routes(monkeypatch, align_mod)
    q = torch.zeros(1, 2, 5, D)
    lens = torch.tensor([5])
    valid = torch.ones(1, 5, dtype=torch.bool)
    with pytest.raises(_Routed) as routed:
        align_mod._launch(q, q, q, valid, lens, lens, 0.2)
    assert routed.value.args == (("general", D) if D > 256
                                 else ("tensor cores", "alignment_attention"))


def _pad(t, width):
    return F.pad(t, (0, width - t.shape[-1]))


@pytest.mark.parametrize("D", [32, 80, 96, 160, 200])
def test_flash_padding_is_exact(D):
    """``attention_bf16_reference`` on q, k, v zero-padded to the kernel's
    width with the true D's scale equals it on the unpadded inputs."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 40, D))
                                .astype(np.float32)) for _ in range(3))
    valid = torch.arange(40)[None] < torch.tensor([[40], [23]])
    width = padded_head_dim(D)
    out = attention_bf16_reference(*(_pad(t, width) for t in (q, k, v)),
                                   valid, scale=D ** -0.5)
    assert out.shape[-1] == width and not out[..., D:].any()
    torch.testing.assert_close(out[..., :D],
                               attention_bf16_reference(q, k, v, valid),
                               atol=PAD_ATOL, rtol=0)


@pytest.mark.parametrize("D", [30, 66, 150])
def test_alignment_padding_is_exact(D):
    """``alignment_tf32x3_reference`` on inputs zero-padded to a multiple of
    4 with the true D's scale equals it on the unpadded inputs: ``out``,
    the argmax and the guided numerator."""
    rng = np.random.default_rng(D)
    q = torch.from_numpy(rng.standard_normal((2, 2, 50, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 17, D))
                             .astype(np.float32)) for _ in range(2))
    src, mel = torch.tensor([17, 11]), torch.tensor([50, 31])
    valid = torch.arange(17)[None] < src[:, None]
    width = -(-D // 4) * 4
    out, idx, gnum = alignment_tf32x3_reference(
        *(_pad(t, width) for t in (q, k, v)), valid, src, mel,
        scale=D ** -0.5)
    e_out, e_idx, e_gnum = alignment_tf32x3_reference(q, k, v, valid, src,
                                                      mel)
    assert not out[..., D:].any()
    torch.testing.assert_close(out[..., :D], e_out, atol=PAD_ATOL, rtol=0)
    assert torch.equal(idx, e_idx)
    torch.testing.assert_close(gnum, e_gnum, atol=PAD_ATOL, rtol=1e-6)
