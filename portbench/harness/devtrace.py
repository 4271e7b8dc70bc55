"""The device trace of a measured window: every operation the card ran,
on the host's clock, and the harness's own spans around its calls into
the program.

The profiler records the device alone (CUPTI activity, no host events), so
tracing costs the host little. A session opens with marker kernels (a
session can lose its first records); the last one, launched right after a
host clock reading, ties the device's timestamps to ``time.perf_counter``
to within a launch's latency. The reading is in memory until the harness
reduces it.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

MARKERS, MARKER_KERNEL = 8, "spin_kernel"


class DeviceTrace:
    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.ops: list[tuple[str, float, float]] = []
        self._prof = None
        self._offset = 0.0
        self._t_mark = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self._t_mark = time.perf_counter()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def stop(self) -> None:
        """End the session and keep its device operations as (name, start,
        end) on the host clock, the markers left out."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = []
        mark = None
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            if MARKER_KERNEL in name:
                if mark is None or e.start_ns() > mark:
                    mark = e.start_ns()
                continue
            events.append((name, e.start_ns(), e.end_ns()))
        if mark is None:
            raise RuntimeError("the device trace lost its marker kernels: no clock tie")
        off = mark * 1e-9 - self._t_mark
        self.ops = sorted((n, s * 1e-9 - off, t * 1e-9 - off) for n, s, t in events)
        self._prof = None


def clip(ops, lo: float, hi: float):
    """The operations that overlap [lo, hi), cut to it."""
    return [(n, max(s, lo), min(t, hi)) for n, s, t in ops if t > lo and s < hi]


def busy_intervals(ops) -> list[tuple[float, float]]:
    """The union of the operations' intervals, merged and sorted."""
    out: list[list[float]] = []
    for _, s, t in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def busy_seconds(ops) -> float:
    return sum(t - s for s, t in busy_intervals(ops))


def by_name(ops, top: int = 10) -> list[list]:
    """The ``top`` device operations by summed time: [[name, seconds]]."""
    tot: dict[str, float] = {}
    for n, s, t in ops:
        tot[n] = tot.get(n, 0.0) + (t - s)
    return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(ops, spans, lo: float, hi: float, top: int = 10) -> list[list]:
    """The ``top`` longest stretches of [lo, hi) in which the device ran
    nothing, each named by the harness span the host was in at the gap's
    middle ("harness" between calls): [[name, seconds]]."""
    gaps, at = [], lo
    for s, t in busy_intervals(ops) + [(hi, hi)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, t in gaps[:top]:
        mid = (s + t) / 2
        name = next((n for n, a, b in spans if a <= mid < b), "harness")
        out.append([name, t - s])
    return out


def time_of(ops, patterns) -> float:
    """Seconds of the operations whose name holds one of ``patterns`` and
    none of the ``!``-marked ones."""
    want = [p for p in patterns if not p.startswith("!")]
    drop = [p[1:] for p in patterns if p.startswith("!")]
    return sum(t - s for n, s, t in ops
               if any(p in n for p in want) and not any(p in n for p in drop))
