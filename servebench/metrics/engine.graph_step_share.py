"""Share of the traced decode steps that replayed a captured CUDA graph:
the ``engine.step.model`` spans that hold an ``engine.step.replay`` span,
in %.  None where the trace holds no replay span (a program that captures
no graph)."""

import bisect


def read(run):
    t = run.trace
    if t is None:
        return None
    steps = [(s, e) for s, e, n in t.cpu_ops if n == "engine.step.model"]
    replays = sorted(s for s, _, n in t.cpu_ops if n == "engine.step.replay")
    if not steps or not replays:
        return None
    held = sum(1 for s, e in steps
               if bisect.bisect_right(replays, e) > bisect.bisect_left(replays, s))
    return 100.0 * held / len(steps)
