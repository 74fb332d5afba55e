"""Share of the traced slice in which the card is idle while the host is
inside the engine's model call (``engine.admit.model``,
``engine.step.model``): the model's own dispatch, in %.  None without the
program's spans."""

from servebench import spans


def read(run):
    return spans.idle_share(run.trace, spans.MODEL_CALLS)
