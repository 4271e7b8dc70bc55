"""The readers of the program's step regions (``harness/progspans.py`` and
the five ``*_ms`` metrics on it), on hand-built records with known
regions; the idle-gap naming by the innermost region; and, on the CPU, a
traced window making the program record its regions with no tracer handed
to it (set-up's steps record none)."""

import itertools
import time
from contextlib import contextmanager
from types import SimpleNamespace

import pytest
import torch

from portbench.harness import devtrace, manifest, progspans, trainrun
from portbench.harness.run_record import RunRecord
from portbench.tests.tiny import DENSE, MOE

READS = {"train_forward_ms": "train.forward", "train_backward_ms": "train.backward",
         "train_optimizer_ms": "train.optimizer", "moe_dispatch_fwd_ms": "moe.dispatch",
         "moe_combine_fwd_ms": "moe.combine"}


def _tracer(steps):
    """A program tracer with ``steps`` traced steps of known device times:
    step i's forward takes 10 + i ms over two microbatches, its backward
    20 + i, its optimizer 3, each MoE region 1 (two layers a microbatch)."""
    from repro_torch.obs import Tracer

    ticks = itertools.count()
    tracer = Tracer(clock=lambda: next(ticks) * 1e-4)  # host times from 0 s on
    for _ in range(steps):
        with tracer.region("train.step"):
            for name in ("train.upload", "train.forward", "train.backward", "train.forward",
                         "train.backward", "train.optimizer", "train.read"):
                with tracer.region(name):
                    if name == "train.forward":
                        for _ in range(2):
                            for sub in ("moe.dispatch", "moe.combine"):
                                with tracer.region(sub):
                                    pass
    at = {}
    for r in tracer.regions:  # device intervals laid end to end from each step's start
        ms = {"train.forward": (10 + r.rid) / 2, "train.backward": (20 + r.rid) / 2,
              "train.optimizer": 3.0, "moe.dispatch": 1.0, "moe.combine": 1.0}.get(r.name, 0.0)
        start = at.setdefault(r.rid, 10.0 + r.rid)
        r.d0, r.d1 = start, start + ms * 1e-3
        if not r.name.startswith("moe."):
            at[r.rid] = r.d1
    return tracer


def _rec(arch, window=(0.0, float("inf")), trace=True):
    mix = manifest.mix_of("train.b16s512")
    return RunRecord("train", arch, mix, 1, window, 1.0, 0.0, 0,
                     trace=SimpleNamespace(ops=[]) if trace else None)


@pytest.mark.parametrize("name", sorted(READS))
def test_readers_read_the_median_step_of_their_region(name, monkeypatch):
    monkeypatch.setattr(progspans, "program_tracer", lambda: _tracer(5))
    want = {"train_forward_ms": 12.0, "train_backward_ms": 22.0, "train_optimizer_ms": 3.0,
            "moe_dispatch_fwd_ms": 4.0, "moe_combine_fwd_ms": 4.0}[name]
    assert manifest.reader(name).read(_rec(MOE)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READS))
def test_readers_read_nothing_without_regions(name, monkeypatch):
    read = manifest.reader(name).read
    monkeypatch.setattr(progspans, "program_tracer", lambda: _tracer(3))
    assert read(_rec(DENSE, trace=False)) is None  # untraced
    assert read(_rec(DENSE, window=(-2.0, -1.0))) is None  # no region in the window
    monkeypatch.setattr(progspans, "program_tracer", lambda: None)
    assert read(_rec(DENSE)) is None
    monkeypatch.undo()
    from repro_torch.obs import trace

    monkeypatch.delattr(trace, "last_profiled")  # a program from before the regions
    assert progspans.program_tracer() is None and read(_rec(DENSE)) is None


def test_regions_of_the_window_only(monkeypatch):
    tracer = _tracer(4)
    monkeypatch.setattr(progspans, "program_tracer", lambda: tracer)
    lo, hi = tracer.regions[0].t1, float("inf")  # the first step began before the window
    got = progspans.regions(_rec(DENSE, window=(lo, hi)))
    assert {r.rid for r in got} == {1, 2, 3}
    assert progspans.step_ms(_rec(DENSE, window=(lo, hi)), "train.forward") == pytest.approx(12)


def _host(name, t0, t1):
    return SimpleNamespace(name=name, t0=t0, t1=t1)


def test_idle_gaps_take_the_innermost_region_and_are_unchanged_without():
    ops = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 3.5, 4.0), ("k", 7.0, 7.5)]
    spans = [("Trainer.step", 0.0, 6.0), ("Trainer.step", 6.5, 9.0)]
    regs = [_host("train.step", 0.0, 4.8), _host("train.forward", 0.1, 1.2),
            _host("train.backward", 1.2, 3.2), _host("train.read", 3.2, 4.8),
            _host("train.step", 6.5, 9.0)]
    assert progspans.idle_gaps(ops, spans, [], 0.0, 10.0) == devtrace.idle_gaps(
        ops, spans, 0.0, 10.0)
    got = progspans.idle_gaps(ops, spans, regs, 0.0, 10.0)
    assert got == [["Trainer.step", 3.0], ["train.step", 2.5], ["train.backward", 1.0],
                   ["train.read", 0.5]]
    assert progspans.idle_by_region(ops, regs, 0.0, 10.0) == {
        "outside": 3.0, "train.step": 2.5, "train.backward": 1.0, "train.read": 0.5}
    name_at = progspans.namer(regs)
    assert [name_at(t) for t in (-1.0, 0.0, 0.1, 1.2, 4.8, 5.5, 6.5, 9.0)] == [
        None, "train.step", "train.forward", "train.backward", None, None, "train.step", None]


def test_covered_share_of_the_busy_time():
    ops = [("k", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)]  # busy 3 s
    assert progspans.covered_share(ops, [(0.0, 10.0)]) == 1.0
    assert progspans.covered_share(ops, [(1.0, 3.5), (1.5, 2.5)]) == pytest.approx(1.5 / 3)
    assert progspans.covered_share(ops, [(5.0, 6.0)]) == 0.0
    assert progspans.covered_share([], [(0.0, 1.0)]) == 0.0


class ProfilerTrace:
    """The device trace's calls into the profiler, on the CPU."""

    def __init__(self):
        self.spans, self.ops, self._prof = [], [], None

    def start(self):
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        self._prof.__enter__()

    @contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def stop(self):
        self._prof.__exit__(None, None, None)


@pytest.mark.parametrize("arch", [DENSE, MOE], ids=["dense", "moe"])
def test_a_traced_window_makes_the_program_record_its_regions(arch):
    from repro_torch.obs import trace

    mix = dict(manifest.mix_of("train.b16s512"), batch=2, seq=16, max_steps_per_s=2000)
    trace.profiled("cpu")  # no profiler: clears any earlier profiled run
    tr = ProfilerTrace()
    rec = trainrun.run(arch, mix, 2**31 + 5, 0.05, tr, time.perf_counter(),
                       torch.device("cpu"))
    tracer = trace.last_profiled()
    assert tracer is not None and trace.current() is None
    steps = [r for r in tracer.regions if r.name == "train.step"]
    assert len(steps) == rec.attempted == len(tr.spans)  # the window's steps, not set-up's
    for r, (_, a, b) in zip(steps, tr.spans, strict=True):
        assert rec.window[0] <= a <= r.t0 <= r.t1 <= b <= rec.window[1]
    moe = sum(r.name == "moe.dispatch" for r in tracer.regions)
    assert moe == (arch.layers * len(steps) if arch.experts else 0)
    assert progspans.regions(rec) is None  # host intervals only: no device to read


def test_the_report_splits_the_step_and_checks_the_clock(monkeypatch):
    from portbench import spans

    tracer = _tracer(3)
    monkeypatch.setattr(progspans, "program_tracer", lambda: tracer)
    steps = [r for r in tracer.regions if r.name == "train.step"]
    for r in steps:  # each step's device interval ends where its read ends
        r.d1 = max(x.d1 for x in tracer.regions if x.rid == r.rid)
    ops = [("k", r.d0, r.d0 + 0.02) for r in steps]  # inside each step's fwd / bwd
    rec = _rec(DENSE)
    rec.trace, rec.window, rec.step_s = SimpleNamespace(ops=ops), (0.0, 20.0), [0.0355] * 3
    out = spans.report(rec, [])
    assert out["steps"] == 3 and out["busy_in_step"] == 1.0
    assert out["busy_in_fwd_bwd_opt"] == 1.0
    assert out["device_ms"]["train.forward"] == pytest.approx(11.0)
    assert out["device_ms"]["train.step"] == pytest.approx(11 + 21 + 3)
    assert out["step_device_vs_host"] == pytest.approx(35 / 35.5 - 1)
    assert out["step_self_ms"]["device"] == pytest.approx(0.0)
    assert sum(out["idle_ms_per_step"].values()) == pytest.approx((20 - 0.06) * 1e3 / 3)
    monkeypatch.setattr(progspans, "program_tracer", lambda: None)
    assert spans.report(rec, []) is None
