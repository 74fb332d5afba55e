"""Share of the traced slice in which no operation ran on the card, in %."""


def read(run):
    t = run.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
