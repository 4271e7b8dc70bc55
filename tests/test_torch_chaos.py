"""Seeded chaos on the port's engine against the reference's: the
reference's grid (paged / dense × single / multi-tenant × off / ngram) with
one seed, one :class:`~repro_torch.serve.ChaosMonkey` a run (cancels,
deadline storms, pool pressure on the paged pool).

Both engines run the same submissions on their own fake clock. They must
agree on what chaos injected, every request's terminal reason and tokens,
the metrics snapshot less ``serve_jit_compiles`` and the trace; survivors
(``max_new``) must equal the port's unperturbed run; the pool must be
drained with nothing stolen. Also: the monkey replays by seed, a step costs
one transfer with it attached, the pressure clamp keeps one request
servable, and the knobs are refused as the reference refuses them.
"""

import pytest
import torch
from test_torch_serve_lifecycle import Ticks, make_engine, snapshot, world  # noqa: F401

from repro.serve import ChaosMonkey as JChaos
from repro_torch.serve import ChaosMonkey

torch.set_num_threads(2)

PROMPTS = [[1, 5, 9], [1, 6, 9, 4], [1, 7, 9], [1, 8, 9, 3], [1, 4, 9]]
GRID = [(paged, mt, draft) for paged in (True, False) for mt in (False, True)
        for draft in ("off", "ngram")]


def submit_all(eng, multitenant: bool) -> list:
    rids = [eng.submit(p, max_new=8, adapter_id=(1 + i % 2) if multitenant else 0)
            for i, p in enumerate(PROMPTS)]
    return [eng.scheduler.get(r) for r in rids]


def chaos_knobs(paged: bool, seed: int = 7) -> dict:
    return dict(seed=seed, cancel_prob=0.3, deadline_prob=0.2,
                pressure_prob=0.5 if paged else 0.0, pressure_frac=0.9)


def chaos_run(world, side: str, knobs: dict, multitenant: bool, **kw):
    chaos = (JChaos if side == "ref" else ChaosMonkey)(**knobs)
    eng, _ = make_engine(world, side, tenants=multitenant, chaos=chaos, **kw)
    reqs = submit_all(eng, multitenant)
    eng.run_to_completion()
    return eng, chaos, [(r.rid, r.done, r.reason, list(r.out)) for r in reqs]


@pytest.mark.parametrize("paged,multitenant,draft", GRID,
                         ids=[f"{'paged' if p else 'dense'}-{'multi' if m else 'single'}-{d}"
                              for p, m, d in GRID])
def test_chaos_grid_matches_reference(world, paged, multitenant, draft):
    kw = dict(paged=paged, draft=draft)
    base, _ = make_engine(world, "port", tenants=multitenant, tracer=False, **kw)
    expect = [r.out for r in (submit_all(base, multitenant), base.run_to_completion())[0]]
    assert all(len(o) == 8 for o in expect)

    je, jchaos, jreqs = chaos_run(world, "ref", chaos_knobs(paged), multitenant, **kw)
    te, tchaos, treqs = chaos_run(world, "port", chaos_knobs(paged), multitenant, **kw)
    assert tchaos.injected == jchaos.injected
    assert sum(tchaos.injected.values()) > 0
    assert treqs == jreqs
    assert snapshot(te) == snapshot(je)
    assert te.tracer.events == je.tracer.events
    for i, (_, done, reason, out) in enumerate(treqs):
        assert done and reason in ("max_new", "cancelled", "deadline")
        if reason == "max_new":
            assert out == expect[i], f"request {i} survived but diverged under chaos"
    assert te.kv.drained() and je.kv.drained()
    if paged:
        assert te.kv.stolen_blocks == 0
    assert te.transfers == te.steps


def test_chaos_replays_by_seed(world):
    outcomes = []
    for seed in (3, 3, 11):
        knobs = dict(seed=seed, cancel_prob=0.4, deadline_prob=0.2, pressure_prob=0.4)
        eng, chaos, reqs = chaos_run(world, "port", knobs, False, paged=True, tracer=False)
        outcomes.append((dict(chaos.injected), [(r[2], tuple(r[3])) for r in reqs]))
        assert eng.kv.drained()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] != outcomes[2]


def test_one_transfer_a_step_with_chaos_attached(world, monkeypatch):
    """Chaos reads host state only: with the monkey firing, every step after
    the prefill costs one ``.cpu()`` fetch."""
    chaos = ChaosMonkey(seed=1, cancel_prob=0.2, pressure_prob=0.5)
    eng, _ = make_engine(world, "port", chaos=chaos, paged=True)
    submit_all(eng, False)
    eng.step()
    while eng.scheduler.has_prefilling():
        eng.step()
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: (calls.append(1),
                                                                  real(t, *a, **k))[1])
    steps = 0
    while eng.step():
        steps += 1
    assert steps > 0 and len(calls) == steps
    assert eng.kv.drained() and sum(chaos.injected.values()) > 0


def test_pool_pressure_clamp_keeps_one_request_servable(world):
    chaos = ChaosMonkey(seed=5, pressure_prob=1.0, pressure_frac=1.0, pressure_hold=1)
    eng, _ = make_engine(world, "port", chaos=chaos, paged=True, slots=2)
    eng.submit([1, 5, 9], max_new=8)
    eng.submit([1, 6, 9], max_new=8)
    reqs = eng.run_to_completion()
    assert chaos.injected["pressure"] > 0
    assert all(r.reason == "max_new" for r in reqs)
    assert eng.kv.drained() and eng.kv.stolen_blocks == 0


@pytest.mark.parametrize("knobs,match", [
    (dict(cancel_prob=1.5), "cancel_prob"), (dict(slow_client_prob=-0.1), "slow_client_prob"),
    (dict(pressure_frac=0.0), "pressure_frac"), (dict(pressure_hold=0), "pressure_hold")])
def test_chaos_knobs_refused_as_the_reference(knobs, match):
    msgs = []
    for cls in (JChaos, ChaosMonkey):
        with pytest.raises(ValueError, match=match) as ei:
            cls(**knobs)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_slow_client_draws_replay_the_reference():
    ref = JChaos(seed=9, slow_client_prob=0.5, slow_client_delay=0.01)
    port = ChaosMonkey(seed=9, slow_client_prob=0.5, slow_client_delay=0.01)
    assert [port.stream_delay() for _ in range(50)] == [ref.stream_delay() for _ in range(50)]
    assert port.injected == ref.injected
