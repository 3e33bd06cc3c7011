"""The alignment kernel's forward share of its roofline, in %: one launch
a MelEncoder layer a step, each launch's least time
(``roofline.alignment_seconds``: f32 q, k, v, out, argmax and guided sums
of the valid rows, the valid rows' and keys' products in 3xTF32) over the
device time of the kernels named below (the kernel and its guided-sum
reduction).  None when the
launches counted on the trace are not the layers a step.  Moves
``train_audio_s_per_s``."""

from portbench.harness import roofline

KERNELS = ("alignment_kernel", "gnum_reduce_kernel")


def read(run):
    steps = run.record.get("launches") or []
    tr = run.cfg["acoustic"]["transformer"]
    t = run.trace
    layers = tr["decoder_layer"]
    if not steps or t.kernel_count(KERNELS[:1]) != layers * len(steps):
        return None
    h = tr["decoder_head"]
    d = tr["decoder_hidden"] // h
    bound = layers * sum(roofline.alignment_seconds(
        x["B"], h, x["T"], x["L"], d, x["src_lens"], x["mel_lens"])
        for x in steps)
    return 100.0 * bound / t.kernel_seconds(KERNELS)
