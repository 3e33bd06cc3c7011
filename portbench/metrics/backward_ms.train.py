"""Device ms a train step of its backward (``tts.step.backward``; autograd
launches its kernels from its own thread, matched to the span by time): the
device time of the kernels launched inside that span, over the number of
``tts.step`` spans in the window (``harness/program_spans.py``).  None
without the program's spans.  Moves ``train_audio_s_per_s``."""

from portbench.harness import program_spans


def read(run):
    p = program_spans.of(run)
    if p is None:
        return None
    return p.device_ms_per("tts.step.backward", "tts.step")
