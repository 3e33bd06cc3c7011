"""Device ms a train step of its update (gradient clip and AdamW,
``tts.step.optimizer``): the
device time of the kernels launched inside that span, over the number of
``tts.step`` spans in the window (``harness/program_spans.py``).  None
without the program's spans.  Moves ``train_audio_s_per_s``."""

from portbench.harness import program_spans


def read(run):
    p = program_spans.of(run)
    if p is None:
        return None
    return p.device_ms_per("tts.step.optimizer", "tts.step")
