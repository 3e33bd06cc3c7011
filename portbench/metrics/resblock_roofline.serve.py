"""The HiFi-GAN resblock kernel's share of its roofline, in %: the least
time of every resblock convolution of the traced window's batches (each
batch vocodes its B items at the bucket of its longest, as the harness's
``cut``) over the device time of the kernels named below (the convolution
and its per-call weight split).  A conv's least time is max(bytes / HBM,
3·2·B·n·C·C·k / the TF32 peak) at n samples, C channels and k taps: its
input and output once, the residual and the running sum where it reads
them, and its weights once; its products in 3xTF32 (three TF32 products
each), the float32-accurate route on tensor cores (on the CUDA cores alone,
at 67 TFLOP/s, the least time is longer still).  None when the launches
counted on the trace are not the generator's resblock convs a batch (the
kernel renamed or replaced, or a program without it).  Moves
``serve_audio_s_per_s``."""

from types import SimpleNamespace

import numpy as np

from portbench.harness import drivers, roofline

KERNELS = ("resblock_conv_kernel", "resblock_weight_split_kernel")


def frames(spec, mel_lens) -> int:
    """The frames a batch vocodes: the driver's own ``Serving.cut``, which
    reads nothing of the driver but its traffic spec."""
    return drivers.Serving.cut(SimpleNamespace(spec=spec),
                               np.asarray(mel_lens))


def resblock_convs(v: dict, T: int):
    """(n samples, C, k, reads) of each resblock conv of one generator
    forward over T mel frames, in the order the kernel runs them; reads is
    the count of (B, C, n) tensors the conv reads besides its input: 0 for
    a ResBlock1's first conv, 1 (the residual) for the others, 2 (the
    running sum too) for the last conv of every resblock after a stage's
    first."""
    n, ch, out = T, v["upsample_initial_channel"], []
    pair = str(v["resblock"]) == "1"
    for u in v["upsample_rates"]:
        n, ch = n * u, ch // 2
        for r, (k, ds) in enumerate(zip(v["resblock_kernel_sizes"],
                                        v["resblock_dilation_sizes"])):
            for i, _ in enumerate(ds):
                last = 2 if r > 0 and i == len(ds) - 1 else 1
                out += ([(n, ch, k, 0), (n, ch, k, last)] if pair
                        else [(n, ch, k, last)])
    return out


def resblock_seconds(v: dict, B: int, T: int) -> float:
    """Least time of one forward's resblock convs at B items of T frames."""
    total = 0.0
    for n, c, k, reads in resblock_convs(v, T):
        bytes_ = roofline.F32 * (B * n * c * (2 + reads) + c * c * k + c)
        ops = 3 * 2 * B * n * c * c * k
        total += max(bytes_ / roofline.HBM_BYTES_S, ops / roofline.TF32_FLOPS)
    return total


def read(run):
    v = run.cfg["vocoder"]
    if v["family"] != "hifigan":
        return None
    launches = run.record.get("launches") or []
    t = run.trace
    per = len(resblock_convs(v, 1))
    if not launches or t.kernel_count(KERNELS[:1]) != per * len(launches):
        return None
    bound = sum(resblock_seconds(v, int(x["B"]), frames(run.spec,
                                                         x["mel_lens"]))
                for x in launches)
    return 100.0 * bound / t.kernel_seconds(KERNELS)
