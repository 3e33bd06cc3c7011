"""The trace arithmetic (busy time, idle gaps and their attribution) and
the roofline bounds on hand-built cases."""

import math

import numpy as np
import pytest

from portbench.tests import tiny  # noqa: F401
from portbench.harness import roofline
from portbench.harness.trace import Trace, gaps, union


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert union(iv) == pytest.approx(3.0)
    assert gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_idle_share_and_attribution():
    t = Trace(window_s=10.0,
              kernels=[("conv", 0.0, 4.0), ("gemm", 4.0, 6.0),
                       ("conv", 8.0, 9.0)],
              spans=[("stage_b", 0.0, 7.0), ("host_copy", 6.5, 8.5),
                     ("stage_a", 7.5, 9.5)])
    assert t.busy_s == pytest.approx(7.0)
    assert 100 * (1 - t.busy_s / t.window_s) == pytest.approx(30.0)
    gaps_by = dict(t.idle_gaps())
    # 6-8: middle 7.0 is in stage_b and host_copy, the shorter wins;
    # 9-10: middle 9.5 in stage_a
    assert gaps_by == {"host_copy": pytest.approx(2.0),
                       "stage_a": pytest.approx(1.0)}
    assert t.device_ops()[0] == ["conv", pytest.approx(5.0)]
    assert t.kernel_seconds(("gemm",)) == pytest.approx(2.0)
    assert t.kernel_count(("conv",)) == 2


def test_upsample_bound_bytes():
    # 2 items, L 4, D 8, T 40; durations 5 each: Σd 20 frames
    d = np.full((2, 4), 5.0)
    s = roofline.upsample_seconds(2, 4, 8, 40, d, [4, 4], 10.0)
    bytes_ = 4 * (2 * 4 * 8 + 2 * 2 * 4 + 2 * 40 * 8 + 2)
    # every phoneme's band (±102 frames) covers all 20 frames
    ops = 2 * 8 * 2 * 4 * 20
    assert s == pytest.approx(max(bytes_ / roofline.HBM_BYTES_S,
                                  ops / roofline.F32_FLOPS))


def test_flash_and_alignment_bounds():
    B, H, T, D = 8, 2, 4096, 192
    keys = [4096] * 8
    s = roofline.flash_seconds(B, H, T, D, keys)
    assert s == pytest.approx(4 * H * D * T * T * B / roofline.BF16_FLOPS)
    # the kernel table's D 192 bound at (8, 2, 4096, 192) over all keys
    assert 0.2 < s * 1e3 < 0.22
    a = roofline.alignment_seconds(48, 2, 896, 128, 128, [128] * 48,
                                   [896] * 48)
    bytes_ = 4 * (2 * 48 * 2 * 896 * 128 + 2 * 48 * 2 * 128 * 128
                  + 48 * 896 + 48) + 48 * 128 + 8 * 48
    assert a == pytest.approx(max(bytes_ / roofline.HBM_BYTES_S,
                                  3 * 4 * 2 * 128 * 896 * 128 * 48
                                  / roofline.TF32_FLOPS))
    assert math.isclose(roofline.MFU_PEAK, 495e12)


def test_bounds_count_valid_rows_only():
    # padded rows past each item's length add neither bytes nor products
    lens = [2000, 3000]
    short = roofline.flash_seconds(2, 2, 4096, 192, lens)
    assert short == pytest.approx(
        4 * 2 * 192 * (2000**2 + 3000**2) / roofline.BF16_FLOPS)
    assert roofline.flash_seconds(2, 2, 8192, 192, lens) == \
        pytest.approx(short)
    mel, src = [500, 700], [60, 90]
    a = roofline.alignment_seconds(2, 2, 896, 128, 128, src, mel)
    bytes_ = 4 * (2 * 2 * 128 * 1200 + 2 * 2 * 128 * 150 + 1200 + 2) \
        + 150 + 16
    ops = 3 * 4 * 2 * 128 * (500 * 60 + 700 * 90)
    assert a == pytest.approx(max(bytes_ / roofline.HBM_BYTES_S,
                                  ops / roofline.TF32_FLOPS))
