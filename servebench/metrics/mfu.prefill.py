"""The admissions' share of the card's peak, in %: each admission's
roofline time (its prompt's model FLOPs at the peak, or its bytes at the
memory's rate, whichever is longer; counts/) summed, over their summed
host wall time, in the window before the profiler started (all of it in
an untraced run)."""

from servebench import counts, stats


def read(run):
    calls = stats.calls_in_window(run, run.admits, stats.quiet(run))
    if not calls:
        return None
    fam = counts.family(run.cfg)
    bound = sum(counts.seconds(*fam.prefill(run.cfg, c.lens[0])) for c in calls)
    return 100.0 * bound / sum(c.end - c.start for c in calls)
