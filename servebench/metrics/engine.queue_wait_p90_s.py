"""90th percentile of due time to the start of admission, over every
request due in the window before the profiler started (all of it in an
untraced run): the wait the engine's loop puts before a prefill, from
the host-clock stamps the harness takes around ``Engine.admit``."""

from servebench import stats


def read(run):
    w = stats.queue_waits(run, stats.quiet(run))
    return stats.percentile(w, 90) if w else None
