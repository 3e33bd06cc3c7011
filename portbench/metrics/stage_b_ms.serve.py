"""Device ms of stage B (the vocoder, ``Synthesizer.stage_b``) a batch:
CUDA events around each call in the traced window, their total over the
batches.  Moves ``serve_audio_s_per_s``."""


def read(run):
    ev = run.record.get("events")
    if ev is None or not ev.count.get("stage_b"):
        return None
    return ev.total["stage_b"] / ev.count["stage_b"]
