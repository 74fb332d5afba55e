"""Output tokens that came back in the window, over its length."""

from servebench import stats


def read(run):
    t0, t1 = run.window
    return stats.tokens_in_window(run) / (t1 - t0)
