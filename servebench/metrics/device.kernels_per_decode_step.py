"""Device operations that start inside each traced decode step's device
side (kernels, copies and fills), mean over the traced steps."""


def read(run):
    t = run.trace
    if t is None:
        return None
    counts = [t.ops_in(c.label) for c in run.steps if c.traced]
    counts = [len(c) for c in counts if c]
    return sum(counts) / len(counts) if counts else None
