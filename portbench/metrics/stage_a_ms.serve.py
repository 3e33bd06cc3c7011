"""Device ms of stage A (text → mel, ``Synthesizer.stage_a``) a batch: CUDA
events around each call in the traced window, their total over the
batches.  Moves ``serve_audio_s_per_s``."""


def read(run):
    ev = run.record.get("events")
    if ev is None or not ev.count.get("stage_a"):
        return None
    return ev.total["stage_a"] / ev.count["stage_a"]
