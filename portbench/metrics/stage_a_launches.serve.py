"""Device kernels and copies a stage A call launches: those whose host
launch (the CUDA API call with the kernel's correlation id)
lies inside a ``tts.stage_a`` span, over the number of such spans
(``harness/program_spans.py``).  None without the program's spans.  Moves
``serve_audio_s_per_s``."""

from portbench.harness import program_spans


def read(run):
    p = program_spans.of(run)
    return None if p is None else p.launches_per_call("tts.stage_a")
