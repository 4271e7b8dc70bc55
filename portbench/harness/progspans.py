"""The program's own step regions in a traced window.

While a torch profiler records (the device trace of a ``--trace 1`` run
is one), the program's trainer runs each step in nested regions
(``train.step`` > ``train.upload``, ``train.forward``, ``train.backward``,
``train.optimizer``, ``train.read``; ``moe.dispatch`` / ``moe.combine``
inside each MoE layer's forward) and records a CUDA timing event at each
region's entry and exit, into the tracer
``repro_torch.obs.trace.last_profiled()``. Nothing reads the events while
the window runs; :func:`regions` resolves them once, after it, through one
anchor (synchronize, read ``time.perf_counter``, record an event), so a
region's device interval lies on the host clock the device trace is tied
to. A program that records no regions (one from before them) gives None
everywhere here, and so does an untraced run.

Besides ``program.py``, this is the one place the harness reaches into
the program.
"""

from __future__ import annotations

import bisect
import statistics

from . import devtrace


def program_tracer():
    """The program's tracer of the latest profiled steps, or None."""
    from repro_torch.obs import trace

    get = getattr(trace, "last_profiled", None)
    return None if get is None else get()


def regions(rec):
    """The program's regions of ``rec``'s window, device intervals
    resolved (``name``, ``rid``, ``parent``, host ``t0`` / ``t1``, device
    ``d0`` / ``d1``), or None."""
    if rec.kind != "train" or rec.trace is None:
        return None
    tracer = program_tracer()
    if tracer is None:
        return None
    tracer.resolve()
    lo, hi = rec.window
    got = [r for r in tracer.regions
           if r.d0 is not None and r.t1 is not None and lo <= r.t0 and r.t1 <= hi]
    return got or None


def step_ms(rec, name: str) -> float | None:
    """Median over the window's steps of the summed device-interval length
    of the step's regions named ``name``, in ms (None without one)."""
    return per_step_ms(regions(rec) or (), name)


def per_step_ms(regs, name: str, device: bool = True) -> float | None:
    """Median over the steps (``rid``) of the summed length of the regions
    named ``name`` (device intervals, or host ones), in ms, or None."""
    per: dict[int, float] = {}
    for r in regs:
        if r.name == name:
            per[r.rid] = per.get(r.rid, 0.0) + ((r.d1 - r.d0) if device else (r.t1 - r.t0))
    return statistics.median(per.values()) * 1e3 if per else None


def namer(regs):
    """``t -> `` the name of the innermost region whose host interval
    [t0, t1) holds ``t``, or None. Regions nest, so one sweep over their
    starts and ends gives the innermost open region between any two of
    them; a lookup is a bisection."""
    marks = sorted([(r.t0, 1, i) for i, r in enumerate(regs)]
                   + [(r.t1, 0, i) for i, r in enumerate(regs)])
    stack, times, names = [], [], []
    for t, start, i in marks:
        if start:
            stack.append(i)
        else:
            stack.remove(i)
        times.append(t)
        names.append(regs[stack[-1]].name if stack else None)

    def name_at(t: float) -> str | None:
        k = bisect.bisect_right(times, t) - 1
        return names[k] if k >= 0 else None

    return name_at


def idle_gaps(ops, spans, regs, lo: float, hi: float, top: int = 10) -> list[list]:
    """:func:`devtrace.idle_gaps` with the program's regions after the
    harness's spans: each gap named by the innermost program region the
    host was in at its middle, else by the harness's span there, else
    "harness". Without regions it is devtrace's list."""
    name_at, out = namer(regs or ()), []
    for s, t in sorted(_gaps(ops, lo, hi), key=lambda g: g[0] - g[1])[:top]:
        mid = (s + t) / 2
        name = name_at(mid) or next((n for n, a, b in spans if a <= mid < b), "harness")
        out.append([name, t - s])
    return out


def idle_by_region(ops, regs, lo: float, hi: float) -> dict[str, float]:
    """Every idle second of [lo, hi) by the innermost program region open
    at the gap's middle ("outside" where none was)."""
    name_at, out = namer(regs), {}
    for s, t in _gaps(ops, lo, hi):
        name = name_at((s + t) / 2) or "outside"
        out[name] = out.get(name, 0.0) + (t - s)
    return out


def covered_share(ops, intervals) -> float:
    """The share of the operations' busy time that lies inside the union
    of ``intervals``."""
    busy = devtrace.busy_intervals(ops)
    cover = devtrace.busy_intervals([("", s, t) for s, t in intervals])
    inside, i, j = 0.0, 0, 0
    while i < len(busy) and j < len(cover):
        (s, t), (a, b) = busy[i], cover[j]
        inside += max(0.0, min(b, t) - max(a, s))
        if t < b:
            i += 1
        else:
            j += 1
    total = sum(t - s for s, t in busy)
    return inside / total if total else 0.0


def _gaps(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    gaps, at = [], lo
    for s, t in devtrace.busy_intervals(ops) + [(hi, hi)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    return gaps

