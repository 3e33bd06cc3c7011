"""Host ms of one ``Synthesizer.synthesize`` call with its waveforms
copied to the host (the copy synchronises), the mean over the traced
window's batches.  Moves ``serve_p95_ms``."""


def read(run):
    s = run.record.get("service_s")
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
