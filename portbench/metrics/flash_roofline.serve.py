"""The flash-attention kernel's share of its roofline, in %: the decoder's
self-attentions past the configuration's flash length (one a decoder layer
a batch), each launch's least time (``roofline.flash_seconds``: f32 q, k,
v and out of the valid rows, the valid rows' and keys' products on bf16
tensor cores) over the device
time of the kernels named below (the kernel and its k/v rounding pass).
None when the launches counted on the trace are not the decoder's layers a
batch.  Moves ``serve_audio_s_per_s``."""

from portbench.harness import roofline

KERNELS = ("flash_attention_kernel", "kv_to_bf16_kernel")


def read(run):
    launches = run.record.get("launches") or []
    tr = run.cfg["acoustic"]["transformer"]
    past = run.cfg["precision"]["attention_bf16_past"]
    per = [x for x in launches if x["T"] > past]
    t = run.trace
    n = tr["decoder_layer"] * len(per)
    if not per or t.kernel_count(KERNELS[:1]) != n:
        return None
    h = tr["decoder_head"]
    d = tr["decoder_hidden"] // h
    bound = tr["decoder_layer"] * sum(roofline.flash_seconds(
        x["B"], h, x["T"], d, x["mel_lens"]) for x in per)
    return 100.0 * bound / t.kernel_seconds(KERNELS)
