"""Dependency-free metrics registry: counters, gauges, fixed-bucket histograms
(the port's copy of ``repro.obs.metrics``, unchanged in behaviour).

One registry serves the whole process (DESIGN §13): the serving engine
binds labeled *children* once at construction and the hot path touches
nothing but a dict-free ``child.inc()`` / ``child.observe()`` — a float
add and (for histograms) a bisect over a dozen bucket bounds. Everything
here is host-side python over values the caller already holds; nothing
imports torch and nothing can trigger a device transfer, which is what
lets instrumentation ride inside the one-device→host-transfer-per-step
serving contract.

Two export surfaces, both deterministic (registration order, then sorted
label values):

* :meth:`MetricsRegistry.expose` — the Prometheus text exposition format
  (``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value`` samples,
  ``_bucket``/``_sum``/``_count`` histogram series with cumulative
  ``le`` buckets), scrape-ready for a file or an HTTP handler;
* :meth:`MetricsRegistry.snapshot` — a JSON-able dict with the same
  information plus per-histogram quantile estimates, the shape the serve
  launcher's ``--metrics-out x.json`` writes.

:class:`NullRegistry` is the metrics-off twin: it hands out no-op
instruments with the same API so instrumented code needs no branches,
and is the metrics-off baseline that instrumentation's cost is measured
against (``chip_smoke.py``'s serve-lifecycle phase).

:func:`percentile` is the port's one exact-percentile implementation —
``chip_smoke.py``'s TTFT/ITL figures and the engine tests both rank
through it instead of hand-rolling index math.
"""

from __future__ import annotations

import json
from bisect import bisect_left

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_INSTRUMENT",
    "LATENCY_BUCKETS",
    "percentile",
]

# wall-time histogram default: exponential 100µs → ~13s, the band a
# compiled serving step on anything from a TPU to the CPU oracle lands in
LATENCY_BUCKETS = tuple(1e-4 * 2.0**i for i in range(18))


def percentile(values, q: float) -> float:
    """Exact rank percentile of ``values`` (nearest-rank, the convention
    the serving bench has always used: sorted, index ``int(q * n)``
    clamped to the last element). ``values`` need not be pre-sorted."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    vs = sorted(values)
    if not vs:
        raise ValueError("percentile of an empty sequence")
    return vs[min(int(q * len(vs)), len(vs) - 1)]


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Prometheus sample values: integers render bare, floats as repr."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared labeled-family machinery: a metric is a *family*; each
    distinct label-value tuple owns one child holding the actual state.
    An unlabeled metric is its own single child (label tuple ``()``)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, _Metric] = {}
        if not self.labelnames:
            self._children[()] = self

    def labels(self, *values) -> "_Metric":
        """Bound child for one label-value tuple (created on first use,
        cached forever — bind once outside the hot path)."""
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values!r}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            child = type(self)(self.name, self.help)
            self._children[key] = child
        return child

    def _label_str(self, key: tuple) -> str:
        if not key:
            return ""
        pairs = ", ".join(
            f'{n}="{_escape(v)}"' for n, v in zip(self.labelnames, key)
        )
        return "{" + pairs + "}"

    def _sorted_children(self):
        return sorted(self._children.items())


class Counter(_Metric):
    """Monotone float counter. ``inc`` only — resets don't exist."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._v += n

    @property
    def value(self) -> float:
        return self._v

    @property
    def total(self) -> float:
        """Sum over every labeled child (== ``value`` when unlabeled)."""
        return sum(c._v for c in self._children.values())

    def _samples(self):
        for key, child in self._sorted_children():
            yield self.name, key, child._v

    def _snap(self, key, child):
        return {"value": child._v}


class Gauge(_Metric):
    """Set/inc/dec current-value gauge (queue depth, pool occupancy …)."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._v += n

    def dec(self, n: float = 1.0) -> None:
        self._v -= n

    @property
    def value(self) -> float:
        return self._v

    total = Counter.total
    _samples = Counter._samples
    _snap = Counter._snap


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative ``le`` buckets, sum and count.

    Buckets are upper bounds, strictly increasing, with ``+Inf`` implied.
    ``observe`` is a bisect + two float adds; quantiles come from
    :meth:`quantile` via linear interpolation inside the winning bucket
    (the ``histogram_quantile`` estimate — use :func:`percentile` on raw
    samples when exactness matters)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=LATENCY_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        if not self.buckets or any(
            a >= b for a, b in zip(self.buckets, self.buckets[1:])
        ):
            raise ValueError(f"buckets must strictly increase: {buckets}")
        super().__init__(name, help, labelnames)
        self._counts = [0] * (len(self.buckets) + 1)  # trailing +Inf
        self._sum = 0.0
        self._count = 0

    def labels(self, *values):
        child = super().labels(*values)
        child.buckets = self.buckets
        if len(child._counts) != len(self.buckets) + 1:
            child._counts = [0] * (len(self.buckets) + 1)
        return child

    def observe(self, v: float) -> None:
        self._counts[bisect_left(self.buckets, v)] += 1
        self._sum += v
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate of the observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self._count == 0:
            return 0.0
        rank = q * self._count
        seen = 0
        for i, c in enumerate(self._counts):
            if seen + c >= rank and c:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (
                    self.buckets[i]
                    if i < len(self.buckets)
                    else max(self._sum / self._count, lo)
                )
                return lo + (hi - lo) * max(rank - seen, 0.0) / c
            seen += c
        return self.buckets[-1]

    def _samples(self):
        for key, child in self._sorted_children():
            cum = 0
            for b, c in zip(child.buckets, child._counts):
                cum += c
                yield f"{self.name}_bucket", key + (("le", _fmt(b)),), cum
            yield (
                f"{self.name}_bucket",
                key + (("le", "+Inf"),),
                child._count,
            )
            yield f"{self.name}_sum", key, child._sum
            yield f"{self.name}_count", key, child._count

    def _snap(self, key, child):
        return {
            "buckets": list(child.buckets),
            "counts": list(child._counts),
            "sum": child._sum,
            "count": child._count,
            "p50": child.quantile(0.50),
            "p95": child.quantile(0.95),
        }


class MetricsRegistry:
    """Ordered collection of metric families with idempotent creation:
    asking twice for the same name returns the same family (so the
    engine, the launcher and a test can all hold handles to one series),
    and a name re-registered with a different type/labels fails loudly.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    enabled = True

    def _make(self, cls, name, help, labels, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labelnames != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} "
                    f"with labels {m.labelnames}"
                )
            return m
        m = cls(name, help, labels, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._make(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._make(Gauge, name, help, labels)

    def histogram(
        self, name, help="", labels=(), buckets=LATENCY_BUCKETS
    ) -> Histogram:
        return self._make(Histogram, name, help, labels, buckets=buckets)

    def get(self, name) -> _Metric | None:
        return self._metrics.get(name)

    def value(self, name, *labelvalues) -> float:
        """Scrape one sample (counters/gauges): test- and bench-facing."""
        m = self._metrics[name]
        key = tuple(str(v) for v in labelvalues)
        child = m._children.get(key)
        if child is None:
            return 0.0
        return child._v

    # ------------------------------------------------------------- export

    def expose(self) -> str:
        """Prometheus text exposition (version 0.0.4): one HELP/TYPE
        header per family, samples in registration order, children in
        sorted label order, histograms as cumulative buckets."""
        lines = []
        for m in self._metrics.values():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for sample_name, key, v in m._samples():
                if key and isinstance(key[-1], tuple):  # histogram le pair
                    plain, extra = key[:-1], key[-1:]
                    pairs = [
                        f'{n}="{_escape(val)}"'
                        for n, val in zip(m.labelnames, plain)
                    ] + [f'{n}="{val}"' for n, val in extra]
                    label_str = "{" + ", ".join(pairs) + "}"
                else:
                    label_str = m._label_str(key)
                lines.append(f"{sample_name}{label_str} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able snapshot of every family: type, help, and one entry
        per labeled child (histograms include bucket counts and p50/p95
        estimates)."""
        out = {}
        for m in self._metrics.values():
            series = []
            for key, child in m._sorted_children():
                series.append(
                    {
                        "labels": dict(zip(m.labelnames, key)),
                        **m._snap(key, child),
                    }
                )
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=False)


class _NullInstrument:
    """No-op stand-in for every instrument type: accepts the full
    Counter/Gauge/Histogram surface and does nothing, so instrumented
    code carries zero metrics-off branches."""

    value = 0.0
    total = 0.0
    count = 0
    sum = 0.0

    def labels(self, *a):
        return self

    def inc(self, n=1.0):
        pass

    def dec(self, n=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def quantile(self, q):
        return 0.0


NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Metrics-off registry: same construction API, no-op instruments,
    empty exports. ``ServeEngine(metrics=False)`` uses this — the
    baseline instrumentation's cost is measured against."""

    enabled = False

    def counter(self, name, help="", labels=()):
        return NULL_INSTRUMENT

    def gauge(self, name, help="", labels=()):
        return NULL_INSTRUMENT

    def histogram(self, name, help="", labels=(), buckets=LATENCY_BUCKETS):
        return NULL_INSTRUMENT

    def get(self, name):
        return None

    def value(self, name, *labelvalues) -> float:
        return 0.0

    def expose(self) -> str:
        return ""

    def snapshot(self) -> dict:
        return {}

    def dump_json(self) -> str:
        return "{}"
