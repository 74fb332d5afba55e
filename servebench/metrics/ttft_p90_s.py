"""90th percentile of time to first token, from each due time, over every
request due in the window (those unanswered at the close at their wait)."""

from servebench import stats


def read(run):
    return stats.percentile(stats.ttfts(run), 90) if stats.due_in_window(run) else None
