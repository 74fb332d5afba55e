"""Sim-time span tracing, exportable as Chrome trace-event JSON.

A :class:`SpanTracer` records *simulation-time* spans — never wall clock;
this module deliberately does not import :mod:`time` or :mod:`datetime`,
and ``tests/test_torch_static.py`` checks for it — organized into named
tracks (one Chrome "thread" per track).  The export is the Chrome
trace-event format (``{"traceEvents": [...]}``), which
https://ui.perfetto.dev loads directly, so a simulated reoptimize cycle,
fault arc, or token-serving bin renders on the same timeline UI real
profilers use.

Two recording styles:

* ``span(track, name, t0, t1)`` — a complete event whose endpoints are
  already known (most simulator instrumentation sites: the event loop knows
  when a phase starts and ends).
* ``begin(track, name, t)`` / ``end(track, t)`` — a stack discipline for
  callers that discover the end later.  Nesting is enforced: a child must
  begin at or after its parent, ``end`` without a matching ``begin`` raises,
  and :meth:`assert_well_formed` flags spans left open.

Everything is deterministic: same call sequence, byte-identical
:meth:`export_json` (insertion-ordered events, sorted keys).  The
:class:`NullTracer` is the zero-cost default when observability is off —
every method is a no-op, so instrumentation sites cost one attribute check.

The port's copy of the JAX package's ``obs/trace.py``, op for op: the
export's bytes equal the reference's for the same call sequence.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

# sim seconds -> trace microseconds (the trace-event format's "ts" unit)
_US = 1e6


class NullTracer:
    """No-op twin of :class:`SpanTracer` (observability off)."""

    enabled = False

    def span(self, track, name, t0, t1, args=None):  # noqa: D102
        pass

    def instant(self, track, name, t, args=None):  # noqa: D102
        pass

    def begin(self, track, name, t, args=None):  # noqa: D102
        pass

    def end(self, track, t, args=None):  # noqa: D102
        pass

    def assert_well_formed(self):  # noqa: D102
        pass

    def span_summary(self) -> Dict:  # noqa: D102
        return {}

    def chrome_trace(self) -> Dict:  # noqa: D102
        return {"displayTimeUnit": "ms", "traceEvents": []}

    def export_json(self) -> str:  # noqa: D102
        return json.dumps(
            self.chrome_trace(), sort_keys=True, separators=(",", ":")
        )


class SpanTracer:
    """Records sim-time spans/instants on named tracks (see module doc)."""

    enabled = True

    def __init__(self) -> None:
        self._events: List[Dict] = []  # finalized, insertion order
        self._tracks: Dict[str, int] = {}  # track name -> tid
        # per-track stack of open begin() frames: (name, t0, args)
        self._open: Dict[str, List[Tuple[str, float, Optional[Dict]]]] = {}

    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = self._tracks[track] = len(self._tracks)
        return tid

    # -- recording ---------------------------------------------------------------
    def span(
        self,
        track: str,
        name: str,
        t0: float,
        t1: float,
        args: Optional[Dict] = None,
    ) -> None:
        """A complete event covering sim-time ``[t0, t1]`` (``t1 == t0`` is
        a zero-duration span: valid trace-event JSON, rendered as a tick)."""
        if t1 < t0 - 1e-12:
            raise ValueError(f"span {name!r} ends before it starts: {t0} -> {t1}")
        self._events.append(
            {
                "name": name,
                "cat": track,
                "ph": "X",
                "ts": t0 * _US,
                "dur": max(t1 - t0, 0.0) * _US,
                "pid": 0,
                "tid": self._tid(track),
                "args": dict(args or {}),
            }
        )

    def instant(
        self, track: str, name: str, t: float, args: Optional[Dict] = None
    ) -> None:
        """A zero-extent marker (trace-event phase ``i``)."""
        self._events.append(
            {
                "name": name,
                "cat": track,
                "ph": "i",
                "s": "t",  # thread-scoped marker
                "ts": t * _US,
                "pid": 0,
                "tid": self._tid(track),
                "args": dict(args or {}),
            }
        )

    def begin(
        self, track: str, name: str, t: float, args: Optional[Dict] = None
    ) -> None:
        """Open a span on ``track``; must be closed by :meth:`end`.  A child
        span may not begin before its parent did (overlap violation)."""
        stack = self._open.setdefault(track, [])
        if stack and t < stack[-1][1] - 1e-12:
            raise ValueError(
                f"span {name!r} on track {track!r} begins at {t} before its "
                f"parent {stack[-1][0]!r} began at {stack[-1][1]}"
            )
        stack.append((name, t, dict(args) if args else None))

    def end(self, track: str, t: float, args: Optional[Dict] = None) -> None:
        """Close the innermost open span on ``track``."""
        stack = self._open.get(track)
        if not stack:
            raise RuntimeError(f"end() without begin() on track {track!r}")
        name, t0, open_args = stack.pop()
        merged = dict(open_args or {})
        merged.update(args or {})
        self.span(track, name, t0, t, args=merged)

    # -- integrity ---------------------------------------------------------------
    def assert_well_formed(self) -> None:
        """Every begin() was closed — call before export."""
        leaked = {
            track: [name for name, _t0, _a in stack]
            for track, stack in self._open.items()
            if stack
        }
        if leaked:
            raise RuntimeError(f"spans left open at export: {leaked}")

    # -- export ------------------------------------------------------------------
    def span_summary(self) -> Dict:
        """Counts only (serialized into ``SimReport.obs`` — the full event
        list lives in the trace export, not the report)."""
        per_track: Dict[str, int] = {t: 0 for t in self._tracks}
        for ev in self._events:
            per_track[ev["cat"]] += 1
        return {
            "events": len(self._events),
            "tracks": dict(sorted(per_track.items())),
        }

    def chrome_trace(self) -> Dict:
        """The trace-event document: thread-name metadata (one per track, so
        Perfetto labels the rows) followed by the recorded events."""
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": tid,
                "args": {"name": track},
            }
            for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1])
        ]
        return {"displayTimeUnit": "ms", "traceEvents": meta + self._events}

    def export_json(self) -> str:
        """Canonical serialization: byte-identical across same-seed runs."""
        self.assert_well_formed()
        return json.dumps(
            self.chrome_trace(), sort_keys=True, separators=(",", ":")
        )
