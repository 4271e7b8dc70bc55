"""Observability of the port (port of ``repro.obs``, DESIGN §13): the
serving engine's metrics and request lifecycle, and the trainer's step
regions.

metrics — dependency-free registry of counters / gauges / fixed-bucket
          histograms with labels, Prometheus text exposition, a JSON
          snapshot, and the port's one exact-percentile implementation;
trace   — request-lifecycle tracer (submit → queued → admitted →
          prefill_chunk(s) → first_token → decode/spec rounds →
          preempt/re-prefill → finish) exporting Chrome trace-event
          JSON (Perfetto-loadable) and JSONL; the same tracer's nesting
          regions time the trainer's step (``train.step`` > upload,
          forward, backward, optimizer, read; ``moe.dispatch`` /
          ``moe.combine``) on the host and, on a CUDA device, through
          timing events put on the host clock by one anchor after the run;
clock   — the one monotonic source every lifecycle timestamp routes
          through (``obs.now``): request stamps, TTFT/ITL observation,
          deadline arithmetic, rate-limit refills and trace timestamps.

The serving side is host-side Python over state the engine already
fetched: it adds no device-to-host transfer and no device operation. A
traced train step adds two timing events a region and nothing else; the
events are read only by ``Tracer.resolve``.
"""

from repro_torch.obs.clock import now
from repro_torch.obs.metrics import (
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    percentile,
)
from repro_torch.obs.trace import Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "MetricsRegistry",
    "NullRegistry",
    "Tracer",
    "now",
    "percentile",
]
