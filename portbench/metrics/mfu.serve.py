"""The whole batch's share of the card's peak, in %: the model FLOPs that
the traced window's batches need at each item's valid lengths
(``flops.acoustic_forward`` + ``flops.vocoder``, from the configuration
alone) per second of the window, over ``roofline.MFU_PEAK``.  Moves
``serve_audio_s_per_s``."""

from portbench.harness import flops, roofline


def read(run):
    launches = run.record.get("launches") or []
    if not launches or run.trace.window_s <= 0:
        return None
    a, v = run.cfg["acoustic"], run.cfg["vocoder"]
    total = sum(flops.acoustic_forward(a, int(L), int(T))
                + flops.vocoder(v, int(T))
                for x in launches
                for L, T in zip(x["src_lens"], x["mel_lens"]))
    return 100.0 * total / run.trace.window_s / roofline.MFU_PEAK
