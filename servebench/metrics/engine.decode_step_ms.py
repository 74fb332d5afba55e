"""Host wall time of the ``Engine.step`` calls over their number, in ms,
in the window before the profiler started (all of it in an untraced run)."""

from servebench import stats


def read(run):
    steps = stats.calls_in_window(run, run.steps, stats.quiet(run))
    return 1e3 * sum(c.end - c.start for c in steps) / len(steps) if steps else None
