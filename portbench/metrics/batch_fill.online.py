"""Requests in a batch of the harness's first-come-first-served batcher,
the mean over the traced window's batches.  Moves ``serve_p95_ms``."""


def read(run):
    f = run.record.get("fills")
    if not f:
        return None
    return sum(f) / len(f)
