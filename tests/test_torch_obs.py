"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``): the same calls on both registries and both
tracers give identical exports, and ``percentile`` agrees.

Each seed drives one random sequence of calls (counters, gauges and
histograms, labelled and not, default and custom buckets) into a
``repro.obs.MetricsRegistry`` and a ``repro_torch.obs.MetricsRegistry``;
``expose()``, ``snapshot()`` and ``dump_json()`` must be equal strings and
dicts. The tracers run on one fake clock each, fed the same readings.
"""

import json
import random

import numpy as np
import pytest

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.obs import metrics as tmetrics

FAMILIES = (
    ("counter", "req_total", "Requests.", ()),
    ("counter", "tok_total", "Tokens by kind.", ("kind",)),
    ("gauge", "queue_depth", "Queue.", ()),
    ("gauge", "pool", "Pool by dtype and tenant.", ("dtype", "tenant")),
    ("histogram", "lat_seconds", "Latency.", ()),
    ("histogram", "accept", "Accepted prefix.", ("kind",)),
)
LABELS = ("mixed", "decode", "spec", 'q"uote', "back\\slash", "new\nline")


def drive(reg, seed: int) -> None:
    """One seeded call sequence on ``reg``."""
    rng = random.Random(seed)
    fams = {}
    for kind, name, help_, labels in FAMILIES:
        if kind == "histogram" and name == "accept":
            fams[name] = reg.histogram(name, help_, labels=labels,
                                       buckets=tuple(float(i) for i in range(5)))
        else:
            fams[name] = getattr(reg, kind)(name, help_, labels=labels)
    for _ in range(300):
        kind, name, _, labels = rng.choice(FAMILIES)
        fam = fams[name]
        inst = fam.labels(*(rng.choice(LABELS) for _ in labels)) if labels else fam
        if kind == "counter":
            inst.inc(rng.choice((1, 1, 2, 0.5, 3.25)))
        elif kind == "gauge":
            getattr(inst, rng.choice(("set", "inc", "dec")))(rng.uniform(-5, 50))
        else:
            inst.observe(rng.choice((rng.expovariate(20.0), rng.randrange(6), 1e-4 * 2**17, 99.0)))
    assert reg.counter("req_total", "Requests.") is fams["req_total"]  # idempotent


@pytest.mark.parametrize("seed", range(4))
def test_registries_export_identically(seed):
    ref, port = jobs.MetricsRegistry(), tobs.MetricsRegistry()
    drive(ref, seed)
    drive(port, seed)
    assert port.expose() == ref.expose()
    assert port.snapshot() == ref.snapshot()
    assert port.dump_json() == ref.dump_json()
    json.loads(port.dump_json())
    for name in ("req_total", "queue_depth"):
        assert port.value(name) == ref.value(name)
    assert port.value("tok_total", "mixed") == ref.value("tok_total", "mixed")
    for q in (0.0, 0.5, 0.95, 1.0):
        assert port.get("lat_seconds").quantile(q) == ref.get("lat_seconds").quantile(q)
    assert port.get("tok_total").total == ref.get("tok_total").total


def test_registry_refusals_match():
    for reg_cls, counter_cls in ((jobs.MetricsRegistry, jobs.Counter),
                                 (tobs.MetricsRegistry, tobs.Counter)):
        reg = reg_cls()
        c = reg.counter("x_total", "X.", labels=("a",))
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total")
        with pytest.raises(ValueError, match="takes labels"):
            c.labels("1", "2")
        with pytest.raises(ValueError, match="cannot decrease"):
            c.labels("1").inc(-1)
        with pytest.raises(ValueError, match="strictly increase"):
            reg.histogram("h", buckets=(1.0, 1.0))
        with pytest.raises(ValueError, match="quantile"):
            reg.histogram("h2").quantile(1.5)
        assert isinstance(c, counter_cls)
    assert tobs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS


def test_null_registry_matches():
    ref, port = jobs.NullRegistry(), tobs.NullRegistry()
    for reg in (ref, port):
        reg.counter("a").labels("x").inc(3)
        reg.gauge("b").set(4)
        reg.histogram("c").observe(0.1)
    assert port.expose() == ref.expose() == ""
    assert port.snapshot() == ref.snapshot() == {}
    assert port.dump_json() == ref.dump_json()
    assert port.value("a") == ref.value("a") == 0.0
    assert port.get("a") is None and port.enabled is False
    assert tmetrics.NULL_INSTRUMENT.quantile(0.5) == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_percentile_agrees(seed):
    rng = np.random.default_rng(seed)
    vals = rng.exponential(0.02, size=int(rng.integers(1, 200))).tolist()
    for q in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        assert tobs.percentile(vals, q) == jobs.percentile(vals, q)
    for bad, err in (([], "empty"), ([1.0], "quantile")):
        for fn in (tobs.percentile, jobs.percentile):
            with pytest.raises(ValueError, match=err):
                fn(bad, 0.5 if bad == [] else 1.5)


class Ticks:
    """A fake clock that advances by a fixed step at every reading."""

    def __init__(self, start=100.0, dt=0.00125):
        self.t, self.dt = start, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def drive_tracer(tracer, seed: int) -> None:
    rng = random.Random(seed)
    for _ in range(60):
        rid = rng.randrange(5)
        if rng.random() < 0.5:
            tracer.instant(rid, rng.choice(("submit", "admitted", "first_token", "finish")),
                           reason=rng.choice(("eos", "max_new")), tokens=rng.randrange(9))
        else:
            ts = tracer.now()
            tracer.span(rid, rng.choice(("queued", "prefill_chunk", "decode")), ts,
                        tracer.now() - rng.choice((0.0, 5.0)), tokens=rng.randrange(4))


@pytest.mark.parametrize("seed", range(2))
def test_tracers_export_identically(seed, tmp_path):
    ref, port = jobs.Tracer(clock=Ticks()), tobs.Tracer(clock=Ticks())
    drive_tracer(ref, seed)
    drive_tracer(port, seed)
    assert len(port) == len(ref) == 60
    assert port.events == ref.events
    assert port.events_for(3) == ref.events_for(3)
    assert port.to_jsonl() == ref.to_jsonl()
    assert port.to_chrome() == ref.to_chrome()
    for name in ("t.jsonl", "t.json"):
        ref.write(tmp_path / f"ref_{name}")
        port.write(tmp_path / name)
        assert (tmp_path / name).read_text() == (tmp_path / f"ref_{name}").read_text()
    chrome = json.loads((tmp_path / "t.json").read_text())
    assert {e["ph"] for e in chrome["traceEvents"]} <= {"M", "i", "X"}


def test_default_clock_is_the_shared_monotonic_source():
    t = tobs.Tracer()
    assert t.clock is tobs.now
    a = tobs.now()
    assert tobs.now() >= a and t.now() >= 0.0
