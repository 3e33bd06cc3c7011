"""The banded upsampling kernel's share of its roofline, in %: the sum of
each launch's least time (``roofline.upsample_seconds``: bytes of the
shapes, operations of each item's Σd) over the device time of the kernels
named below in the traced window.  None when the launches counted on the
trace are not one a batch (the kernel renamed or replaced).  Moves
``serve_audio_s_per_s``."""

from portbench.harness import roofline

KERNELS = ("gaussian_upsample_kernel",)


def read(run):
    launches = run.record.get("launches") or []
    t = run.trace
    if not launches or t.kernel_count(KERNELS) != len(launches):
        return None
    a = run.cfg["acoustic"]
    d = a["transformer"]["encoder_hidden"]
    bound = sum(roofline.upsample_seconds(
        x["B"], x["L"], d, x["T"], x["durations"], x["src_lens"],
        a["gaussian_sigma"]) for x in launches)
    return 100.0 * bound / t.kernel_seconds(KERNELS)
