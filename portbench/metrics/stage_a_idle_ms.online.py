"""Host-side idle of the card inside stage A, ms a call: per
``tts.stage_a`` span (the program's ``Synthesizer.stage_a``, inside each
``synthesize``), its host interval less the union of the device's kernel
intervals within it, the mean over the window's calls
(``harness/program_spans.py``).  None without the program's spans.  Moves
``serve_p95_ms``."""

from portbench.harness import program_spans


def read(run):
    p = program_spans.of(run)
    return None if p is None else p.mean_idle_ms("tts.stage_a")
