"""The control on the card: the reference computed at each precision below
the configuration's (TF32 for float32; fp8 for the bfloat16 attention,
alone and with TF32) reads as not correct against the float32 reference,
at a small size.  The
benchmark's runs do not run it; ``run.py --control 1`` reports it at a
cell's own size."""

import pytest

from portbench.tests import tiny


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_control_fails(card, workload):
    cfg_name, mix_name = tiny.CELLS[workload]
    cfg = tiny.cell.load_config(cfg_name)
    spec = tiny.mix(mix_name)
    if spec["mode"] == "train":
        spec.update(batch=8, sentences=24, mel_pad=256,
                    frames_per_phoneme=6.0, text_buckets=[24])
    r = tiny.cell.run(workload, 2**31 + 77, 1.0, False,
                      tiny.time.perf_counter(), device=card, control=True,
                      cfg=cfg, spec=spec)
    assert r["control"]
    for name, numbers in r["control"].items():
        assert any(c["value"] > c["limit"] for c in numbers.values()), name
    assert r["correct"] is True
