"""Device ms of one train step (``make_train_step``'s step: forward,
backward, clip, AdamW): CUDA events around each step in the traced window,
their total over the steps.  Moves ``train_audio_s_per_s``."""


def read(run):
    ev = run.record.get("events")
    if ev is None or not ev.count.get("step"):
        return None
    return ev.total["step"] / ev.count["step"]
