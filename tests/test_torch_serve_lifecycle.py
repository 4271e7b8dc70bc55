"""The port's request lifecycle against the reference's, on one fake clock
each: cancellation (queued, mid-prefill, mid-decode; paged and dense),
deadline expiry (queued and admitted), deadline-aware shedding, queue-full
and rate-limit sheds with ``retry_after``, DRR against FIFO admission, drain.

Every scenario runs on ``repro.serve.ServeEngine`` and on
``repro_torch.serve.ServeEngine`` (CPU, plain kernel versions) over the same
converted fp32 weights and tenants, each with its own :class:`Ticks` clock
shared by the engine, its scheduler and its tracer. The clock advances at
every reading, so TTFT, ITL, step walls and span times are all nonzero and
equal only if both engines read their clock in the same order. The two runs
must agree on what the scenario saw (return values, sheds and their
``retry_after``), the requests' terminal reasons and tokens, the whole
metrics snapshot less ``serve_jit_compiles`` (the port compiles nothing and
keeps that gauge at 0), and the trace's event sequence.

Also here: with metrics off, on, and on with a tracer, the port dispatches
the same ATen operations op for op (instrumentation is host-only), and a
step still costs one transfer.
"""

import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.models import get_model as j_get_model
from repro.obs import Tracer as JTracer
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.models import get_model
from repro_torch.obs import Tracer
from repro_torch.serve import AdapterStore, ServeEngine

torch.set_num_threads(2)
NO_EOS = 1 << 20
NONE = lambda x: x is None  # noqa: E731


class Ticks:
    """Fake clock: ``dt`` seconds pass at every reading; ``advance`` jumps."""

    def __init__(self, start: float = 0.0, dt: float = 0.001):
        self.t, self.dt = start, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jmodel = j_get_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    rng = np.random.default_rng(3)
    tenants = []
    for _ in range(2):
        idx, val = j_init_adapters(jparams, 2)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    return {"jm": jmodel, "jp": jparams, "tm": tmodel, "tp": tree_to_torch(np_tree(jparams)),
            "tenants": tenants}


def make_engine(world, side: str, *, tenants: bool = False, tracer: bool = True, clock=None,
                **kw):
    """One engine of ``side`` ("ref" or "port") with the scenario defaults;
    returns (engine, clock)."""
    clock = Ticks() if clock is None else clock
    kw = {"slots": 2, "max_len": 64, "eos_id": NO_EOS, "decode_chunk": 2, "paged": True,
          **kw}
    ref = side == "ref"
    store = None
    if tenants:
        store = JStore() if ref else AdapterStore()
        for idx, val in world["tenants"]:
            store.register(idx, val) if ref else store.register(tree_to_torch(idx),
                                                                tree_to_torch(val))
    if tracer:
        kw["tracer"] = (JTracer if ref else Tracer)(clock=clock)
    if ref:
        eng = JEngine(world["jm"], world["jp"], adapter_store=store, clock=clock, **kw)
    else:
        eng = ServeEngine(world["tm"], world["tp"], adapter_store=store, clock=clock,
                          device="cpu", **kw)
    return eng, clock


def shed(fn) -> tuple:
    """Call ``fn``; an intake refusal becomes (class name, message, retry_after)."""
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e), getattr(e, "retry_after", None))


def snapshot(eng) -> dict:
    snap = eng.metrics.snapshot()
    snap.pop("serve_jit_compiles", None)
    return snap


def run_both(world, scenario, **kw) -> dict:
    """``scenario(engine, clock)`` on both engines; asserts that they agree
    and returns the port's (engine, what the scenario returned)."""
    runs = {}
    for side in ("ref", "port"):
        eng, clock = make_engine(world, side, **kw)
        seen = scenario(eng, clock)
        reqs = seen.pop("reqs", [])
        runs[side] = (eng, seen, [(r.rid, r.done, r.reason, list(r.out)) for r in reqs])
    (je, jseen, jreqs), (te, tseen, treqs) = runs["ref"], runs["port"]
    assert tseen == jseen
    assert treqs == jreqs
    assert snapshot(te) == snapshot(je)
    if te.tracer is not None:
        assert te.tracer.events == je.tracer.events
        assert te.tracer.to_chrome() == je.tracer.to_chrome()
    assert te.transfers == te.steps
    assert te.kv.drained() and je.kv.drained()
    assert te.step_seconds_ema == je.step_seconds_ema
    return te, tseen, treqs


def reqs_of(eng, rids):
    return [eng.scheduler.get(r) for r in rids]


# ---------------------------------------------------------- cancellation


def test_cancel_mid_queue(world):
    def scenario(eng, clock):
        rids = [eng.submit([1, 5 + i, 9], max_new=4) for i in range(3)]
        reqs = reqs_of(eng, rids)
        eng.step()  # two admitted, rids[2] still queued
        seen = {"slot": eng.scheduler.slot_of(rids[2]),
                "cancel": [eng.cancel(rids[2]), eng.cancel(rids[2]), eng.cancel(12345)]}
        eng.run_to_completion()
        return {**seen, "reqs": reqs}

    te, seen, reqs = run_both(world, scenario)
    assert seen["slot"] is None and seen["cancel"] == [True, False, False]
    assert [r[2] for r in reqs] == ["max_new", "max_new", "cancelled"]
    assert te.metrics.get("serve_requests_cancelled_total").labels("queued").value == 1
    fin = te.metrics.get("serve_requests_finished_total")
    assert fin.labels("0", "cancelled").value == 1 and fin.labels("0", "max_new").value == 2


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_cancel_mid_prefill_and_mid_decode(world, paged):
    def scenario(eng, clock):
        r0 = eng.submit([1] + [7] * 20, max_new=4)  # several chunk steps of prefill
        r1 = eng.submit([1, 5, 9], max_new=16)
        reqs = reqs_of(eng, [r0, r1])
        eng.step()
        seen = {"mid_prefill": eng.scheduler.get(r0).mid_prefill, "c0": eng.cancel(r0)}
        while eng.scheduler.has_prefilling():
            eng.step()
        eng.step()  # r1 decoding
        seen.update(c1=eng.cancel(r1), idle=eng.step(), gone=eng.scheduler.get(r0) is None)
        return {**seen, "reqs": reqs}

    te, seen, reqs = run_both(world, scenario, paged=paged, prefill_chunk=4)
    assert seen == {"mid_prefill": True, "c0": True, "c1": True, "idle": False, "gone": True}
    assert [r[2] for r in reqs] == ["cancelled", "cancelled"] and reqs[1][3]
    cancelled = te.metrics.get("serve_requests_cancelled_total")
    assert cancelled.labels("prefill").value == 1 and cancelled.labels("decode").value == 1


def test_cancel_leaves_survivors_untouched(world):
    prompts = [[1, 5, 9], [1, 6, 9], [1, 7, 9]]
    eng, _ = make_engine(world, "port", slots=3, tracer=False)
    for p in prompts:
        eng.submit(p, max_new=6)
    expect = [r.out for r in eng.run_to_completion()]

    def scenario(eng, clock):
        rids = [eng.submit(p, max_new=6) for p in prompts]
        reqs = reqs_of(eng, rids)
        eng.step()
        eng.step()
        seen = {"c": eng.cancel(rids[1])}
        eng.run_to_completion()
        return {**seen, "reqs": reqs}

    _, _, reqs = run_both(world, scenario, slots=3)
    assert [r[2] for r in reqs] == ["max_new", "cancelled", "max_new"]
    assert reqs[0][3] == expect[0] and reqs[2][3] == expect[2]


# -------------------------------------------------------------- deadlines


def test_deadline_expiry_queued_and_active(world):
    def scenario(eng, clock):
        rids = [eng.submit([1, 5, 9], max_new=8),
                eng.submit([1, 6, 9], max_new=8, timeout=5.0),
                eng.submit([1, 7, 9], max_new=8, timeout=5.0)]  # queued: slots full
        reqs = reqs_of(eng, rids)
        eng.step()
        seen = {"queued": eng.scheduler.slot_of(rids[2]) is None}
        clock.advance(6.0)  # both deadlines pass
        eng.step()  # the sweep ends the queued and the admitted one
        seen["reasons_now"] = [r.reason for r in reqs]
        eng.run_to_completion()
        return {**seen, "reqs": reqs}

    te, seen, reqs = run_both(world, scenario)
    assert seen == {"queued": True, "reasons_now": [None, "deadline", "deadline"]}
    assert [r[2] for r in reqs] == ["max_new", "deadline", "deadline"] and len(reqs[0][3]) == 8
    expired = te.metrics.get("serve_deadline_expired_total")
    assert expired.labels("queued").value == 1 and expired.total == 2
    assert te.metrics.get("serve_requests_finished_total").labels("0", "deadline").value == 2


def test_deadline_mid_prefill_on_the_dense_cache(world):
    def scenario(eng, clock):
        r0 = eng.submit([1] + [3] * 30, max_new=4, deadline=clock.t + 0.05)
        r1 = eng.submit([1, 4, 9], max_new=5)
        reqs = reqs_of(eng, [r0, r1])
        eng.step()
        seen = {"mid": eng.scheduler.get(r0).mid_prefill}
        clock.advance(1.0)
        eng.run_to_completion()
        return {**seen, "reqs": reqs}

    te, seen, reqs = run_both(world, scenario, paged=False, prefill_chunk=4)
    assert seen["mid"] and [r[2] for r in reqs] == ["deadline", "max_new"]
    assert te.metrics.get("serve_deadline_expired_total").labels("prefill").value == 1


def test_deadline_aware_shedding(world):
    def scenario(eng, clock):
        eng.step_seconds_ema = 0.5  # as if measured: a step costs 500 ms
        seen = {"hopeless": shed(lambda: eng.submit([1, 2], max_new=4, timeout=0.1)),
                "past": shed(lambda: eng.submit([1, 2], max_new=4, deadline=clock.t - 1.0))}
        rid = eng.submit([1, 2], max_new=4, timeout=60.0)
        reqs = reqs_of(eng, [rid])
        eng.run_to_completion()
        return {**seen, "reqs": reqs}

    te, seen, reqs = run_both(world, scenario)
    for key in ("hopeless", "past"):
        assert seen[key][0] == "QueueFullError" and "deadline unreachable" in seen[key][1]
        assert seen[key][2] == 0.0
    assert reqs[0][2] == "max_new"
    assert te.metrics.get("serve_requests_shed_total").labels("deadline").value == 2


def test_step_seconds_ema_skips_each_kinds_first_step(world):
    def scenario(eng, clock):
        seen = {"before": eng.step_seconds_ema}
        eng.submit([1, 5, 9], max_new=2)
        eng.step()  # the first mixed step: not fed
        seen["after_mixed"] = eng.step_seconds_ema
        eng.run_to_completion()  # the first decode step: not fed either
        seen["after_first_run"] = eng.step_seconds_ema
        eng.submit([1, 5, 9], max_new=3)
        eng.run_to_completion()
        seen["warm"] = eng.step_seconds_ema
        return seen

    _, seen, _ = run_both(world, scenario)
    assert seen["before"] is None and seen["after_mixed"] is None
    assert seen["after_first_run"] is None and seen["warm"] > 0


def test_submit_validation_matches(world):
    bad = [dict(prompt=[], max_new=4), dict(prompt=[1, 2], max_new=0),
           dict(prompt=[1, 2], max_new=4, timeout=0.0),
           dict(prompt=[1, 2], max_new=4, temperature="hot"),
           dict(prompt=[1, 2], max_new=4, temperature=[1, 2]),
           dict(prompt=[1, 2], max_new=4, temperature=math.nan),
           dict(prompt=[1, 2], max_new=4, timeout="soon"),
           dict(prompt=[1, 2], max_new=4, timeout=math.inf),
           dict(prompt=[1, 2], max_new=4, deadline="tomorrow"),
           dict(prompt=[1] * 64, max_new=4), dict(prompt=[1, 2], max_new=4, adapter_id=3)]

    def scenario(eng, clock):
        seen = {"bad": [shed(lambda kw=kw: eng.submit(kw.pop("prompt"), **kw))
                        for kw in (dict(b) for b in bad)]}
        return seen

    _, seen, _ = run_both(world, scenario)
    assert all(s[0] == "ValueError" for s in seen["bad"])
    with pytest.raises(ValueError, match="fairness"):
        make_engine(world, "port", fairness="round-robin")


# ------------------------------------------------------- intake and limits


def test_queue_full_and_rate_limit_sheds(world):
    def scenario(eng, clock):
        eng.set_rate_limit(0, rate=1.0, burst=3.0)
        seen = {"burst": [shed(lambda: eng.submit([1, 2], max_new=2))[0] for _ in range(3)],
                "limited": shed(lambda: eng.submit([1, 2], max_new=2))}
        clock.advance(10.0)  # the bucket refills: fill the backlog itself
        seen["more"] = [shed(lambda: eng.submit([1, 2], max_new=2))[0] for _ in range(2)]
        seen["full"] = shed(lambda: eng.submit([1, 2], max_new=2))
        done = eng.run_to_completion()
        return {**seen, "reqs": done}

    te, seen, reqs = run_both(world, scenario, queue_limit=5)
    assert seen["burst"] == ["ok"] * 3 and seen["more"] == ["ok"] * 2
    assert seen["limited"][0] == "RateLimitedError" and seen["limited"][2] > 0
    assert seen["full"][0] == "QueueFullError" and seen["full"][2] > 0
    assert len(reqs) == 5 and all(r[2] == "max_new" for r in reqs)
    shed_c = te.metrics.get("serve_requests_shed_total")
    assert shed_c.labels("rate_limit").value == 1 and shed_c.labels("queue_full").value == 1


def admission_order(eng) -> list[int]:
    return [e["rid"] for e in eng.tracer.events if e["name"] == "admitted"]


def test_drr_against_fifo_admission_order(world):
    """A hot tenant's 6 requests, then a cold tenant's 2: under FIFO the cold
    tenant waits behind the whole backlog, under DRR its head is admitted
    within one rotation. Both packages admit in the same order under each
    policy; every request's greedy tokens are the same under both."""
    def scenario(eng, clock):
        rids = [eng.submit([1, 5 + i, 9], max_new=3, adapter_id=1) for i in range(6)]
        rids += [eng.submit([1, 20 + i, 9], max_new=3, adapter_id=2) for i in range(2)]
        reqs = reqs_of(eng, rids)
        eng.run_to_completion()
        return {"order": admission_order(eng), "rids": rids, "reqs": reqs}

    got = {}
    for policy in ("fifo", "drr"):
        _, seen, reqs = run_both(world, scenario, tenants=True, slots=1, fairness=policy,
                                 quantum=8)
        got[policy] = (seen, reqs)
    fifo, drr = got["fifo"][0], got["drr"][0]
    cold = fifo["rids"][6]
    assert fifo["order"] == fifo["rids"]
    assert drr["order"].index(cold) < fifo["order"].index(cold)
    assert [r[3] for r in got["fifo"][1]] == [r[3] for r in got["drr"][1]]


def test_drain_closes_intake_and_finishes_in_flight(world):
    def scenario(eng, clock):
        rids = [eng.submit([1, 5 + i, 9], max_new=4) for i in range(3)]
        reqs = reqs_of(eng, rids)
        done = eng.drain()
        return {"done": sorted(r.rid for r in done), "draining": eng.draining,
                "late": shed(lambda: eng.submit([1, 2], max_new=2)), "reqs": reqs}

    _, seen, reqs = run_both(world, scenario)
    assert seen["draining"] and seen["late"][0] == "RuntimeError"
    assert "draining" in seen["late"][1]
    assert all(r[2] == "max_new" for r in reqs)


# -------------------------------------------- instrumentation is host-only


class OpCount(TorchDispatchMode):
    """Every ATen operation dispatched while on, by name."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_instrumentation_dispatches_no_operation(world, paged):
    """A tenant run (set-up included) dispatches the same ATen operations,
    op for op, with metrics off, on, and on with a tracer; the greedy tokens
    are the same and a step costs one transfer."""
    counts, outs = [], []
    for metrics, tracer in ((False, False), (True, False), (True, True)):
        with OpCount() as seen:
            eng, _ = make_engine(world, "port", tenants=True, tracer=tracer, metrics=metrics,
                                 paged=paged, prefill_chunk=8, slots=3)
            for i, p in enumerate(([1, 5, 9, 2] * 3, [1, 6], [1, 7, 9] * 5, [1, 8, 3])):
                eng.submit(p, max_new=5, adapter_id=i % 3)
            reqs = eng.run_to_completion()
        counts.append(seen.counts)
        outs.append([r.out for r in reqs])
        assert eng.transfers == (eng.steps if metrics else 0)
    assert counts[0] == counts[1] == counts[2]
    assert outs[0] == outs[1] == outs[2]
