"""The HiFi-GAN resblock kernel's share of its roofline, in %: the least
time of every resblock convolution of the traced window's batches (each
batch vocodes its B items at the frames ``drivers.py`` recorded,
``vocoder_frames``; the convolutions as the vocoder family's
``resblock_convs`` lists them) over the device time of the kernels named
below (the convolution and its per-call weight split).  A conv's least
time is ``roofline.resblock_seconds``: max(bytes / HBM, 3·2·B·n·C·C·k /
the TF32 peak) at n samples, C channels and k taps.  None when the
vocoder family has no resblocks, or when the launches counted on the trace
are not the generator's resblock convs a batch (the kernel renamed or
replaced, or a program without it).  Moves ``serve_audio_s_per_s``."""

from portbench.harness import roofline

KERNELS = ("resblock_conv_kernel", "resblock_weight_split_kernel")


def read(run):
    convs = getattr(run.vocoder, "resblock_convs", None)
    if convs is None:
        return None
    v = run.cfg["vocoder"]
    launches = run.record.get("launches") or []
    t = run.trace
    per = len(convs(v, 1))
    if not launches or t.kernel_count(KERNELS[:1]) != per * len(launches):
        return None
    bound = sum(roofline.resblock_seconds(int(x["B"]), convs(
        v, int(x["vocoder_frames"]))) for x in launches)
    return 100.0 * bound / t.kernel_seconds(KERNELS)
