"""The whole batch's share of the card's peak, in %: the model FLOPs that
the traced window's batches need at each item's valid lengths (the
acoustic family's ``forward_flops`` + the vocoder family's, from the
configuration alone) per second of the window, over
``roofline.MFU_PEAK``.  Moves ``serve_audio_s_per_s``."""

from portbench.harness import roofline


def read(run):
    launches = run.record.get("launches") or []
    if not launches or run.trace.window_s <= 0:
        return None
    a, v = run.cfg["acoustic"], run.cfg["vocoder"]
    total = sum(run.acoustic.forward_flops(a, int(L), int(T))
                + run.vocoder.forward_flops(v, int(T))
                for x in launches
                for L, T in zip(x["src_lens"], x["mel_lens"]))
    return 100.0 * total / run.trace.window_s / roofline.MFU_PEAK
