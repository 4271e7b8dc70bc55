"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``): the same calls on both registries and both
tracers give identical exports, and ``percentile`` agrees.

Each seed drives one random sequence of calls (counters, gauges and
histograms, labelled and not, default and custom buckets) into a
``repro.obs.MetricsRegistry`` and a ``repro_torch.obs.MetricsRegistry``;
``expose()``, ``snapshot()`` and ``dump_json()`` must be equal strings and
dicts. The tracers run on one fake clock each, fed the same readings.
The port's step regions (the trainer's) have no reference counterpart:
their nesting, self time, clock and exports are checked on their own.
"""

import json
import random

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace

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


def _regions(tracer):
    """train.step > (upload, forward > dispatch, backward), then a second root."""
    with tracer.region("train.step", rid=7):
        with tracer.region("train.upload"):
            pass
        with tracer.region("train.forward"):
            assert ttrace.current() is tracer
            with tracer.region("moe.dispatch"):
                pass
        with tracer.region("train.backward"):
            pass
    with tracer.region("train.step"):
        pass


def test_regions_nest_and_carry_their_parent():
    tracer = tobs.Tracer(clock=Ticks())
    assert ttrace.current() is None
    _regions(tracer)
    assert ttrace.current() is None
    got = [(r.name, r.rid, r.parent) for r in tracer.regions]
    assert got == [("train.step", 7, None), ("train.upload", 7, 0), ("train.forward", 7, 0),
                   ("moe.dispatch", 7, 2), ("train.backward", 7, 0), ("train.step", 1, None)]
    for r in tracer.regions:
        assert r.t1 > r.t0 and r.d0 is None and r.events is None
        if r.parent is not None:
            p = tracer.regions[r.parent]
            assert p.t0 < r.t0 and r.t1 < p.t1
    tracer.resolve()  # no device: nothing to put on the clock
    assert all(r.d0 is None for r in tracer.regions)
    assert len(tracer) == 0 and tracer.to_jsonl().count("\n") == len(tracer.regions) - 1


def test_self_time_is_the_span_less_its_childrens_coverage():
    tracer = tobs.Tracer(clock=Ticks(dt=1.0))
    _regions(tracer)
    r = tracer.regions
    kids = [i for i, x in enumerate(r) if x.parent == 0]
    want = (r[0].t1 - r[0].t0) - sum(r[i].t1 - r[i].t0 for i in kids)
    assert tracer.self_seconds(0) == want == 4.0
    assert tracer.self_seconds(2) == (r[2].t1 - r[2].t0) - (r[3].t1 - r[3].t0)
    assert tracer.self_seconds(3) == r[3].t1 - r[3].t0
    # device intervals: children that overlap each other count once
    for x, (a, b) in zip(r, [(0, 10), (1, 4), (3, 6), (5, 6), (12, 13), (20, 21)]):
        x.d0, x.d1 = a, b
    assert tracer.self_seconds(0, device=True) == 10 - 5
    assert tracer.self_seconds(2, device=True) == 3 - 1


def test_regions_run_on_the_shared_clock():
    tracer = tobs.Tracer()
    assert tracer.clock is tobs.now
    a = tobs.now()
    with tracer.region("train.step"):
        pass
    b = tobs.now()
    assert a <= tracer.regions[0].t0 <= tracer.regions[0].t1 <= b


def test_chrome_export_holds_the_training_regions(tmp_path):
    tracer = tobs.Tracer(clock=Ticks())
    tracer.instant(3, "submit")
    _regions(tracer)
    tracer.regions[0].d0, tracer.regions[0].d1 = 100.5, 100.75  # as resolved
    tracer.write(tmp_path / "t.json")
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    host = [e for e in ev if e["ph"] == "X" and e["pid"] == 1 and e["tid"] == 0]
    dev = [e for e in ev if e["ph"] == "X" and e["pid"] == 1 and e["tid"] == 1]
    assert [e["name"] for e in host] == [r.name for r in tracer.regions]
    assert host[1]["ts"] == pytest.approx((tracer.regions[1].t0 - tracer._t0) * 1e6)
    assert [(e["name"], e["dur"]) for e in dev] == [("train.step", pytest.approx(0.25e6))]
    assert {e["args"]["name"] for e in ev if e["ph"] == "M"} >= {"req3", "train", "host",
                                                                 "device"}
    tracer.write(tmp_path / "t.jsonl")
    lines = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert lines[0]["name"] == "submit" and [x["name"] for x in lines[1:]] == [
        r.name for r in tracer.regions]
    assert lines[1]["device_dur"] == pytest.approx(0.25e6) and lines[2]["device_ts"] is None


def test_no_tracer_is_a_shared_no_op_and_profiles_get_one():
    assert ttrace.region(None, "train.step") is ttrace.region(None, "moe.combine")
    with ttrace.region(None, "train.step"):
        assert ttrace.current() is None
    assert ttrace.profiled(torch.device("cpu")) is None and ttrace.last_profiled() is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tracer = ttrace.profiled(torch.device("cpu"))
        assert isinstance(tracer, tobs.Tracer) and ttrace.profiled("cpu") is tracer
    assert ttrace.last_profiled() is tracer
    assert ttrace.profiled("cpu") is None and ttrace.last_profiled() is None
