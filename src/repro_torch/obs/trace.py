"""Request-lifecycle tracer: span events from submit to finish (the port's
copy of ``repro.obs.trace``).

The serving engine emits one event stream per run (DESIGN §13): for each
request — identified by its ``rid`` — the lifecycle reads

    submit → queued → admitted → prefill_chunk(s) → first_token (TTFT)
           → decode / spec_round(s) → [preempt → queued → admitted →
             prefill_chunk(s) again — the exact re-prefill] → finish

as instants (``submit``, ``admitted``, ``first_token``, ``preempt``,
``finish``) and duration spans (``queued``, ``prefill_chunk``,
``decode``, ``spec_round``). Every event is recorded host-side from
state the engine already holds — recording is an append of one small
dict, no torch, no device traffic.

Timestamps come from an injectable ``clock`` (seconds; default
``repro_torch.obs.clock.now`` — the SAME monotonic source the scheduler
stamps ``Request.t_submit``/``t_last`` with and the engine feeds its
TTFT/ITL histograms and deadline arithmetic from, DESIGN §16, so trace
spans and latency metrics are exactly comparable) and are stored in
microseconds relative to tracer construction, which is exactly the
Chrome trace-event convention:
:meth:`to_chrome` emits a Perfetto-loadable ``{"traceEvents": [...]}``
document (``ph: "X"`` complete events for spans, ``ph: "i"`` instants,
one ``tid`` per request plus a ``thread_name`` metadata event), and
:meth:`to_jsonl` the flat one-event-per-line form for grep/pandas.
"""

from __future__ import annotations

import json

import repro_torch.obs.clock as _clock

__all__ = ["Tracer"]


class Tracer:
    def __init__(self, clock=None):
        self.clock = clock if clock is not None else _clock.now
        self._t0 = self.clock()
        self.events: list[dict] = []

    def now(self) -> float:
        """Microseconds since tracer construction (trace timebase)."""
        return (self.clock() - self._t0) * 1e6

    # ---------------------------------------------------------- recording

    def instant(self, rid: int, name: str, ts: float | None = None, **args):
        self.events.append(
            {
                "rid": int(rid),
                "name": name,
                "ph": "i",
                "ts": self.now() if ts is None else ts,
                "args": args,
            }
        )

    def span(self, rid: int, name: str, ts: float, end: float, **args):
        """Complete span: ``ts``/``end`` in the trace timebase (µs), as
        returned by :meth:`now` — the engine stamps both around its
        compiled call and hands them in, so one wall-clock read serves
        every slot's span for that step."""
        self.events.append(
            {
                "rid": int(rid),
                "name": name,
                "ph": "X",
                "ts": ts,
                "dur": max(end - ts, 0.0),
                "args": args,
            }
        )

    # ------------------------------------------------------------ queries

    def events_for(self, rid: int) -> list[dict]:
        return [e for e in self.events if e["rid"] == rid]

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------------- export

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (load in Perfetto / chrome://tracing):
        pid 0 is the serve process, tid = rid so each request renders as
        its own track, spans as ``X`` complete events, lifecycle marks as
        thread-scoped instants."""
        out = []
        seen: set[int] = set()
        for e in self.events:
            rid = e["rid"]
            if rid not in seen:
                seen.add(rid)
                out.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": 0,
                        "tid": rid,
                        "args": {"name": f"req{rid}"},
                    }
                )
            ev = {
                "name": e["name"],
                "ph": e["ph"],
                "ts": e["ts"],
                "pid": 0,
                "tid": rid,
                "args": e["args"],
            }
            if e["ph"] == "X":
                ev["dur"] = e["dur"]
            else:
                ev["s"] = "t"  # thread-scoped instant
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e, sort_keys=True) for e in self.events)

    def write(self, path) -> None:
        """Write the trace: ``.jsonl`` → flat JSONL, anything else →
        Chrome trace-event JSON."""
        path = str(path)
        with open(path, "w") as f:
            if path.endswith(".jsonl"):
                f.write(self.to_jsonl() + "\n")
            else:
                json.dump(self.to_chrome(), f)
                f.write("\n")
