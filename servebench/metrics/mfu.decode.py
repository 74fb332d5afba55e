"""The decode steps' share of the card's peak, in %: each step's roofline
time (its live slots' model FLOPs at the peak, or the weights, cache and
state bytes at the memory's rate, whichever is longer; counts/) summed,
over their summed host wall time, in the window before the profiler
started (all of it in an untraced run)."""

from servebench import counts, stats


def read(run):
    calls = [c for c in stats.calls_in_window(run, run.steps, stats.quiet(run)) if c.lens]
    if not calls:
        return None
    fam = counts.family(run.cfg)
    bound = sum(counts.seconds(*fam.decode(run.cfg, c.lens)) for c in calls)
    return 100.0 * bound / sum(c.end - c.start for c in calls)
