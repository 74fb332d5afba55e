"""Per-request flight recorder for the token-level serving model.

Aggregates (a p99 TTFT, 92.7k refusals) say *that* a cell suffered; the
flight recorder says *why*: it captures each :class:`TokenRequest`'s
lifecycle as an ordered event list —

    arrival -> queued -> admitted -> first_token
            -> (preempted | resumed | refused | backoff | migrated
                | crashed)* -> completed | deadline_dropped
                | retry_dropped | shed | truncated

with a cause attribute on every terminal event, so a tail-latency request
can be read end to end.  Recording is bounded: only the first
``record_limit`` distinct requests get event lists; later requests bump the
explicit ``truncated`` counter instead of growing memory without bound (a
micro-scale flash-crowd cell makes tens of thousands of requests).

Timestamps are sim seconds (``t_s`` — never wall clock; this module does
not import :mod:`time`).  The snapshot is deterministic: requests sorted by
rid, keys sorted by the report serializer.

The port's copy of the JAX package's ``obs/flight.py``, op for op.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class FlightRecorder:
    """Bounded per-request lifecycle capture (see module doc)."""

    def __init__(self, record_limit: int = 256) -> None:
        if record_limit < 0:
            raise ValueError(f"record_limit must be >= 0, got {record_limit}")
        self.record_limit = int(record_limit)
        self.truncated = 0  # requests seen past the limit (not recorded)
        self._records: Dict[int, Dict] = {}  # rid -> record

    # -- recording ---------------------------------------------------------------
    def arrival(
        self,
        rid: int,
        service: str,
        t_s: float,
        priority: int = 1,
        deadline_s: Optional[float] = None,
    ) -> None:
        """Open a record (or count it against the truncation budget)."""
        if rid in self._records:
            return
        if len(self._records) >= self.record_limit:
            self.truncated += 1
            return
        rec: Dict = {
            "rid": rid,
            "service": service,
            "arrival_s": float(t_s),
            "priority": int(priority),
            "outcome": "in_system",
            "cause": "",
            "preemptions": 0,
            "retries": 0,
            "events": [{"event": "arrival", "t_s": float(t_s)}],
        }
        if deadline_s is not None and deadline_s != float("inf"):
            rec["deadline_s"] = float(deadline_s)
        self._records[rid] = rec

    def note(self, rid: int, event: str, t_s: float, **attrs) -> None:
        """Append one lifecycle event to ``rid``'s record (no-op when the
        request fell past the record limit)."""
        rec = self._records.get(rid)
        if rec is None:
            return
        ev: Dict = {"event": event, "t_s": float(t_s)}
        for k in sorted(attrs):
            ev[k] = attrs[k]
        rec["events"].append(ev)
        if event in ("preempted", "migrated", "crashed"):
            rec["preemptions"] += 1
        elif event == "backoff":
            rec["retries"] += 1

    def close(self, rid: int, outcome: str, t_s: float, cause: str = "") -> None:
        """Terminal event with cause attribution (``completed``,
        ``deadline_dropped``, ``retry_dropped``, ``shed``, ``truncated``)."""
        rec = self._records.get(rid)
        if rec is None:
            return
        rec["outcome"] = outcome
        rec["cause"] = cause
        rec["events"].append(
            {"event": outcome, "t_s": float(t_s), **({"cause": cause} if cause else {})}
        )

    # -- export ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-ready dict: rid-sorted records + the truncation accounting."""
        return {
            "record_limit": self.record_limit,
            "tracked": len(self._records),
            "truncated": self.truncated,
            "requests": [
                self._records[rid] for rid in sorted(self._records)
            ],
        }
