"""Share of the traced slice in which the card is idle while the host is
inside ``engine.admit`` or ``engine.step`` but outside their model calls:
the engine's own host work (page tables, the tokens' copies, the wait for
the logits, sampling), in %.  None without the program's spans."""

from servebench import spans


def read(run):
    return spans.idle_share(run.trace, spans.CALLS, spans.MODEL_CALLS)
