"""Share of the traced window in which no kernel ran on the card:
1 - (union of the kernels' intervals) / (window), in %.  Moves the cell's
end-to-end metric."""


def read(run):
    t = run.trace
    if t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
