"""The port's tracer: request-lifecycle events for the serving engine (the
port's copy of ``repro.obs.trace``) and nesting step regions for the
trainer, timed on the host and, on a CUDA device, on the device too.

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

Step regions (:meth:`Tracer.region`) are the trainer's: ``train.step``
around each step, its children ``train.upload``, ``train.forward`` /
``train.backward`` (once per microbatch), ``train.optimizer`` and
``train.read``, and ``moe.dispatch`` / ``moe.combine`` inside each MoE
layer's forward. A region keeps its name, the ``rid`` it belongs to (the
step), the region open around it and its host start and end on the
tracer's clock, in seconds. A tracer built with a CUDA ``device`` also
records a timing event on the current stream at each region's entry and
exit; nothing reads them until :meth:`Tracer.resolve`, which waits for the
device once, reads the clock and records one anchor event, and puts every
event on the host clock through that anchor — the tie the benchmark's
device trace makes with its marker kernel, so a region's device interval
lies on the CUPTI operations' timeline to within a launch's latency.
While a region is open its tracer is :func:`current` (how the MoE layer
finds it without an argument); a step run under a torch profiler with no
tracer of its own records into :func:`profiled`'s tracer, so a profile of
the device always carries the step's phases.
"""

from __future__ import annotations

import contextlib
import json

import torch

import repro_torch.obs.clock as _clock

__all__ = ["Region", "Tracer", "current", "last_profiled", "profiled", "region"]

_NO_REGION = contextlib.nullcontext()
_ACTIVE: Tracer | None = None  # the tracer with an open region (see current())
_PROFILED: Tracer | None = None  # the tracer of steps run under a profiler (see profiled())


class Region:
    """One step region: host start / end (``t0`` / ``t1``, seconds on the
    tracer's clock), device start / end (``d0`` / ``d1``, the same clock,
    after :meth:`Tracer.resolve`; None without a CUDA device) and the index
    of its ``parent`` in :attr:`Tracer.regions` (None for a root)."""

    __slots__ = ("name", "rid", "parent", "t0", "t1", "d0", "d1", "events")

    def __init__(self, name: str, rid: int, parent: int | None, t0: float):
        self.name, self.rid, self.parent, self.t0 = name, rid, parent, t0
        self.t1 = self.d0 = self.d1 = None
        self.events = None  # (entry, exit) torch.cuda.Event until resolved

    def to_dict(self, t_base: float) -> dict:
        """The region in the trace timebase: µs since ``t_base``."""
        us = lambda t: None if t is None else (t - t_base) * 1e6  # noqa: E731
        return {"name": self.name, "rid": self.rid, "parent": self.parent,
                "ts": us(self.t0), "dur": (self.t1 - self.t0) * 1e6,
                "device_ts": us(self.d0),
                "device_dur": None if self.d0 is None else (self.d1 - self.d0) * 1e6}


class Tracer:
    def __init__(self, clock=None, device=None):
        self.clock = clock if clock is not None else _clock.now
        self._t0 = self.clock()
        self.events: list[dict] = []
        self.regions: list[Region] = []
        self._open: list[int] = []
        self._roots = 0
        self._timed = device is not None and torch.device(device).type == "cuda"

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

    @contextlib.contextmanager
    def region(self, name: str, rid: int | None = None):
        """A step region around the block, a child of the region open
        around it. ``rid`` defaults to the parent's, and for a root to the
        number of roots before it."""
        global _ACTIVE
        parent = self._open[-1] if self._open else None
        if rid is None:
            rid = self.regions[parent].rid if parent is not None else self._roots
        self._roots += parent is None
        r = Region(name, int(rid), parent, self.clock())
        if self._timed:
            r.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            r.events[0].record()
        self.regions.append(r)
        self._open.append(len(self.regions) - 1)
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield r
        finally:
            if r.events is not None:
                r.events[1].record()
            r.t1 = self.clock()
            self._open.pop()
            _ACTIVE = prev

    def resolve(self) -> None:
        """Put every recorded region's device events on the host clock:
        wait for the device once, read the clock, record an anchor event,
        and take each event's distance to it. Regions already resolved,
        and a tracer without a CUDA device, are left as they are."""
        todo = [r for r in self.regions if r.events is not None and r.t1 is not None]
        if not todo:
            return
        torch.cuda.synchronize()
        t = self.clock()
        anchor = torch.cuda.Event(enable_timing=True)
        anchor.record()
        torch.cuda.synchronize()
        for r in todo:
            r.d0 = t - r.events[0].elapsed_time(anchor) * 1e-3
            r.d1 = t - r.events[1].elapsed_time(anchor) * 1e-3
            r.events = None

    def self_seconds(self, i: int, device: bool = False) -> float:
        """Region ``i``'s length less the part of it its children cover
        (host interval, or the device interval with ``device``)."""
        lo, hi = self._interval(self.regions[i], device)
        kids = sorted(self._interval(r, device) for r in self.regions if r.parent == i)
        covered, at = 0.0, lo
        for a, b in kids:
            a, b = max(a, at), min(b, hi)
            if b > a:
                covered += b - a
                at = b
        return (hi - lo) - covered

    @staticmethod
    def _interval(r: Region, device: bool) -> tuple[float, float]:
        return (r.d0, r.d1) if device else (r.t0, r.t1)

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
        if self.regions:
            out.extend(self._chrome_regions())
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def _chrome_regions(self) -> list[dict]:
        """The step regions as pid 1: host intervals on tid 0, device
        intervals (resolved ones) on tid 1, so the enqueue's lead shows."""
        out = [{"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "train"}},
               {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0, "args": {"name": "host"}},
               {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
                "args": {"name": "device"}}]
        for r in self.regions:
            d = r.to_dict(self._t0)
            out.append({"name": r.name, "ph": "X", "ts": d["ts"], "dur": d["dur"], "pid": 1,
                        "tid": 0, "args": {"rid": r.rid}})
            if r.d0 is not None:
                out.append({"name": r.name, "ph": "X", "ts": d["device_ts"],
                            "dur": d["device_dur"], "pid": 1, "tid": 1, "args": {"rid": r.rid}})
        return out

    def to_jsonl(self) -> str:
        lines = [json.dumps(e, sort_keys=True) for e in self.events]
        lines += [json.dumps(r.to_dict(self._t0), sort_keys=True) for r in self.regions]
        return "\n".join(lines)

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


def current() -> Tracer | None:
    """The tracer with a region open (the trainer's, during a step), else
    None — also in serving, whose tracer records no regions."""
    return _ACTIVE


def region(tracer: Tracer | None, name: str, rid: int | None = None):
    """``tracer.region(name, rid)``, or a shared no-op context when
    ``tracer`` is None: what an untraced step pays is this test."""
    return _NO_REGION if tracer is None else tracer.region(name, rid)


def profiled(device) -> Tracer | None:
    """The tracer a step with no tracer of its own records into while a
    torch profiler records (on ``device``, so with device events on CUDA),
    else None. The tracer lives from the first such step to the next step
    run with no profiler: :func:`last_profiled` reads it after the
    profile."""
    global _PROFILED
    if not torch.autograd.profiler._is_profiler_enabled:
        _PROFILED = None
        return None
    if _PROFILED is None:
        _PROFILED = Tracer(device=device)
    return _PROFILED


def last_profiled() -> Tracer | None:
    """The tracer of the latest run of profiled steps (see
    :func:`profiled`), or None."""
    return _PROFILED
