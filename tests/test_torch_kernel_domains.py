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
  widths (flash: 64, 128, 192 or 256, past 256 a multiple of 64 for the
  wide kernel; alignment: a multiple of 4) with the scale of the true D.
  The plain versions that round where the kernels do are held, on padded
  inputs with that scale, to themselves on the unpadded ones: zero columns
  add exact zeros, so what is left is the order of the CPU's f32 sums
  (1e-6).  Past 256 both wrappers route to their wide kernels, checked here
  with the launchers stubbed.
- The wide kernels' schedules in plain PyTorch (``attention_wide_reference``,
  ``alignment_wide_reference``: output slices, scores summed over
  64-column chunks of D, an online softmax over key tiles) are held to the
  two-pass plain versions that round at the same points, at D 320, 384 and
  512: ``attention_bf16_tolerance`` (it covers an online softmax's moved
  rounding), and for the alignment ``TF32X3_ATOL``/``TF32X3_MEAN`` on
  ``out`` (the card tests' bounds), ``GNUM_ATOL``/``GNUM_RTOL`` and an
  equal argmax.  The two plain versions themselves stay within those
  tolerances past 256, so the wide kernels keep them.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from smart_nar_fast_tts_tpu_torch.kernels import (
    alignment_tf32x3_reference, alignment_wide_reference,
    attention_bf16_reference, attention_bf16_tolerance,
    attention_wide_reference)
from smart_nar_fast_tts_tpu_torch.kernels import alignment as align_mod
from smart_nar_fast_tts_tpu_torch.kernels import attention as flash_mod
from smart_nar_fast_tts_tpu_torch.kernels.attention import padded_head_dim
from smart_nar_fast_tts_tpu_torch.kernels.upsample import (
    BAND_SIGMAS, gaussian_upsample_tile_reference)
from smart_nar_fast_tts_tpu_torch.ops import gaussian_upsample

F32_ATOL = 1e-5
PAD_ATOL = 1e-6
OLD_BAND = 6.0
TF32X3_ATOL, TF32X3_MEAN = 8e-6, 1e-6
GNUM_ATOL, GNUM_RTOL = 1e-4, 1e-5


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
                                      (256, 256), (257, 320), (300, 320),
                                      (320, 320), (384, 384), (513, 576),
                                      (1024, 1024)])
def test_padded_head_dim(d, width):
    assert padded_head_dim(d) == width


class _Routed(Exception):
    """Raised by the stubbed launchers with the route taken."""


def _stub_routes(monkeypatch, module):
    """The wrapper module's two launchers stubbed: each raises ``_Routed``
    with its route and the head dim it would launch at."""
    def route(name):
        def launch(q, *args):
            raise _Routed(name, q.shape[-1])
        return launch
    monkeypatch.setattr(module, "_launch_tc", route("tensor cores"))
    monkeypatch.setattr(module, "_launch_wide", route("wide"))


@pytest.mark.parametrize("D", [129, 160, 192, 200, 255, 256, 257, 320, 512])
def test_flash_route_by_head_dim(monkeypatch, D):
    """Up to 256 the flash wrapper launches the first tensor-core kernel at
    D padded to 64, 128, 192 or 256, past it the wide one at D padded to a
    multiple of 64 (its ``_launch`` called directly: on the CPU the wrapper
    takes the plain version)."""
    _stub_routes(monkeypatch, flash_mod)
    q = torch.zeros(1, 2, 5, D)
    valid = torch.ones(1, 5, dtype=torch.bool)
    with pytest.raises(_Routed) as routed:
        flash_mod._launch(q, q, q, valid)
    assert routed.value.args == (("wide", -(-D // 64) * 64) if D > 256
                                 else ("tensor cores", padded_head_dim(D)))


@pytest.mark.parametrize("D", [128, 150, 192, 256, 257, 320, 512])
def test_alignment_route_by_head_dim(monkeypatch, D):
    """The same for the alignment wrapper: the first kernel up to 256, the
    wide one past it, both at D padded to a multiple of 4."""
    _stub_routes(monkeypatch, align_mod)
    q = torch.zeros(1, 2, 5, D)
    lens = torch.tensor([5])
    valid = torch.ones(1, 5, dtype=torch.bool)
    with pytest.raises(_Routed) as routed:
        align_mod._launch(q, q, q, valid, lens, lens, 0.2)
    assert routed.value.args == ("wide" if D > 256 else "tensor cores",
                                 -(-D // 4) * 4)


def _pad(t, width):
    return F.pad(t, (0, width - t.shape[-1]))


@pytest.mark.parametrize("D", [32, 80, 96, 160, 200, 260, 300, 320])
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


@pytest.mark.parametrize("D", [320, 384, 512])
def test_flash_wide_schedule(D):
    """``attention_wide_reference`` (D in 64-column chunks, output slices of
    192 + 128, 192 + 192 or 256 + 256 columns, an online softmax over
    64-key tiles) against the two-pass ``attention_bf16_reference`` within
    ``attention_bf16_tolerance``, on prefix masks with a hole, a fully masked
    item and a last key tile of 6 keys."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 2, 50, D))
                                .astype(np.float32)) for _ in range(3))
    k, v = (torch.cat([t, t[:, :, :20]], dim=2) for t in (k, v))  # Lk 70
    valid = torch.arange(70)[None] < torch.tensor([[70], [23], [0]])
    valid[0, 30] = False
    got = attention_wide_reference(q, k, v, valid)
    ref = attention_bf16_reference(q, k, v, valid)
    tol = attention_bf16_tolerance(q, k, v, valid, ref)
    assert got.shape == q.shape
    assert ((got - ref).abs() <= tol).all()
    assert not got[2].any()


@pytest.mark.parametrize("D", [320, 384, 512])
def test_alignment_wide_schedule(D):
    """``alignment_wide_reference`` (scores in 3xTF32 over 64-column chunks
    of D, key chunks of 32 with an online softmax, output slices of at most
    192 columns, the guided numerator and argmax from slice 0) against the
    two-pass ``alignment_tf32x3_reference``: out within TF32X3_ATOL at most
    and TF32X3_MEAN on average, gnum within GNUM_ATOL/GNUM_RTOL, the same
    argmax."""
    rng = np.random.default_rng(D + 1)
    q = torch.from_numpy(rng.standard_normal((3, 2, 45, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((3, 2, 70, D))
                             .astype(np.float32)) for _ in range(2))
    src, mel = torch.tensor([70, 41, 66]), torch.tensor([45, 30, 39])
    valid = torch.arange(70)[None] < src[:, None]
    out, idx, gnum = alignment_wide_reference(q, k, v, valid, src, mel)
    e_out, e_idx, e_gnum = alignment_tf32x3_reference(q, k, v, valid, src,
                                                      mel)
    gap = (out - e_out).abs()
    assert gap.max() <= TF32X3_ATOL and gap.mean() <= TF32X3_MEAN
    torch.testing.assert_close(gnum, e_gnum, atol=GNUM_ATOL, rtol=GNUM_RTOL)
    assert torch.equal(idx, e_idx)


@pytest.mark.parametrize("D", [320, 512, 1024])
def test_alignment_plain_versions_agree_wide(D):
    """Past 256 the f32 plain version and the 3xTF32 one stay within the
    tolerances that hold the kernels (``out`` TF32X3_ATOL at most and
    TF32X3_MEAN on average, gnum GNUM_ATOL/GNUM_RTOL): so the kernels keep
    the D ≤ 256 bounds there, with no bound derived for the widths."""
    rng = np.random.default_rng(D + 2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, n, D))
                                .astype(np.float32)) for n in (150, 300, 300))
    src, mel = torch.tensor([300, 211]), torch.tensor([150, 97])
    valid = torch.arange(300)[None] < src[:, None]
    out, _, gnum = align_mod.alignment_reference(q, k, v, valid, src, mel)
    e_out, _, e_gnum = alignment_tf32x3_reference(q, k, v, valid, src, mel)
    gap = (out - e_out).abs()
    assert gap.max() <= TF32X3_ATOL and gap.mean() <= TF32X3_MEAN
    torch.testing.assert_close(gnum, e_gnum, atol=GNUM_ATOL, rtol=GNUM_RTOL)


def test_upsampling_cuda_body_takes_the_operators_order(monkeypatch):
    """The upsampling operator's CUDA body hands its arguments to the
    launcher in the launcher's order (the operator takes ``max_len``
    before ``phon_valid``, the launcher after): the launcher stubbed, the
    body called directly."""
    from smart_nar_fast_tts_tpu_torch.kernels import upsample
    seen = {}
    monkeypatch.setattr(upsample, "_launch",
                        lambda *args: seen.setdefault("upsample", args))
    x, d, valid = torch.zeros(1, 3, 4), torch.ones(1, 3), torch.ones(1, 3)
    upsample._cuda_impl(x, d, 7, valid, 10.0)
    assert seen["upsample"] == (x, d, valid, 7, 10.0)
