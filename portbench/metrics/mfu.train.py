"""The whole step's share of the card's peak, in %: the forward and
backward FLOPs that the traced window's steps need at each item's valid
lengths (the acoustic family's ``train_flops``, from the configuration
alone) per second of the window, over ``roofline.MFU_PEAK``.  Moves
``train_audio_s_per_s``."""

from portbench.harness import roofline


def read(run):
    steps = run.record.get("launches") or []
    if not steps or run.trace.window_s <= 0:
        return None
    a = run.cfg["acoustic"]
    total = sum(run.acoustic.train_flops(a, int(L), int(T))
                for x in steps for L, T in zip(x["src_lens"], x["mel_lens"]))
    return 100.0 * total / run.trace.window_s / roofline.MFU_PEAK
