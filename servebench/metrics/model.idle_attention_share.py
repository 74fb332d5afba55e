"""Share of the traced slice in which the card is idle while the host is
inside a ``model.attention`` span (a block's norm, attention and
residual add), in %.  None without the program's spans."""

from servebench import spans


def read(run):
    return spans.idle_share(run.trace, ("model.attention",))
