"""A tensor-parallel engine's invariants and lockstep, at tp 2 on the CPU.

One spawn of two ranks (gloo, a ``file://`` rendezvous) runs, on the
world of ``test_torch_tp_serve.py`` (reduced qwen2-1.5b, float32, 4
kv-heads and 8 heads):

* the reference's ``_INVARIANTS`` on every rank: raw device-to-host
  fetches (``Tensor.cpu`` calls, less those of the control record, which
  lives in host memory) = transfers = steps, the total pool bytes
  equal a tp = 1 engine's, per-shard bytes × 2 = total, the
  ``serve_tp_size`` gauge reads 2 and the per-shard bytes gauge the
  per-shard bytes;
* a tenant whose ``wo`` and ``wdown`` indices fall in both ranks' halves of
  ``d_in``, serving the reference's tp = 1 tokens;
* a temperature 0.8 run: every rank samples the same tokens;
* deadlines on the leader's fake clock (the followers' clock stands
  still): every rank expires the same requests at the same step;
* the leader's chaos schedule (cancels, deadline storms, pool pressure):
  every rank ends every request the same way and drains its pool.
"""

import numpy as np
import pytest
import torch

from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro_torch.convert import tree_to_torch
from repro_torch.distributed.collectives import close_tp, init_tp, run_ranks
from repro_torch.serve import AdapterStore, ChaosMonkey
from repro_torch.serve import engine as engine_mod
from test_torch_tp_serve import ENGINE, PROMPTS, j_world, port_engine

NO_EOS = 1 << 20


class Ticks:
    """Fake clock: ``dt`` seconds pass at every reading."""

    def __init__(self, dt: float):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def straddling_tenant(world):
    """One tenant (numpy trees) whose ``wo`` / ``wdown`` delta rows hold an
    index in the low half of ``d_in`` and one in the high half, for every
    layer and column; magnitude indices and seeded values elsewhere."""
    _, _, _, tenants = world
    idx, val = tenants[0]
    idx = {k: v for k, v in idx.items()}
    idx["blocks"] = dict(idx["blocks"])
    rng = np.random.default_rng(11)
    for name in ("wo", "wdown"):
        i = np.array(idx["blocks"][name]["w"])
        half = int(world[2]["blocks"][name]["w"].shape[-2]) // 2
        i[..., 0, :] = rng.integers(0, half, i[..., 0, :].shape)
        i[..., 1, :] = rng.integers(half, 2 * half, i[..., 1, :].shape)
        idx["blocks"][name] = {"w": i}
    return idx, val


def terminations(eng) -> list:
    """Record (rid, reason, tokens) of every request the engine ends."""
    log = []
    real = eng._terminate

    def hook(slot, req, reason):
        real(slot, req, reason)
        log.append((req.rid, reason, list(req.out)))

    eng._terminate = hook
    return log


def lead_or_follow(eng, submit) -> None:
    if eng.tp_group.leader:
        submit(eng)
        eng.run_to_completion()
        eng.close()
    else:
        eng.follow()


def engine_rank(rank, tp, init_method):
    torch.set_num_threads(1)
    world = j_world("qwen2-1.5b")
    group = init_tp(rank, tp, "cpu", init_method, timeout=120)
    out = {}
    try:
        # the invariants: one raw fetch a step on every rank
        eng, _ = port_engine("qwen2-1.5b", False, dict(ENGINE, paged=True), group, world)
        calls, control = [], []
        real, real_record = torch.Tensor.cpu, engine_mod.broadcast_record

        def record(*a):  # the control record rides host memory, not a device fetch
            control.append(1)
            try:
                return real_record(*a)
            finally:
                control.pop()

        torch.Tensor.cpu = lambda t: (control or calls.append(1), real(t))[1]
        engine_mod.broadcast_record = record
        try:
            lead_or_follow(eng, lambda e: [e.submit(p, max_new=6) for p in PROMPTS])
        finally:
            torch.Tensor.cpu, engine_mod.broadcast_record = real, real_record
        out["invariants"] = {
            "fetches": len(calls), "transfers": eng.transfers, "steps": eng.steps,
            "total": eng.kv.pool_bytes(), "shard": eng.kv.pool_bytes_per_shard(),
            "g_tp": eng.metrics.value("serve_tp_size"),
            "g_shard": eng.metrics.value("serve_pool_bytes_per_shard", "fp32")}

        # a tenant straddling both ranks' d_in halves
        eng, _ = port_engine("qwen2-1.5b", False, dict(ENGINE, paged=True), group, world)
        eng.store = AdapterStore()
        eng.store.register(*map(tree_to_torch, straddling_tenant(world)))
        log = terminations(eng)
        lead_or_follow(eng, lambda e: [e.submit(p, max_new=6, adapter_id=1) for p in PROMPTS])
        out["straddle"] = sorted(log)

        # sampling at temperature 0.8 with one seed on every rank
        eng, _ = port_engine("qwen2-1.5b", False, dict(ENGINE, paged=True, temperature=0.8,
                                                       eos_id=NO_EOS, seed=5), group, world)
        log = terminations(eng)
        lead_or_follow(eng, lambda e: [e.submit(p, max_new=10) for p in PROMPTS])
        out["sampled"] = sorted(log)

        # deadlines on the leader's clock; a follower's clock stands still
        clock = Ticks(0.01) if group.leader else (lambda: 0.0)
        eng, _ = port_engine("qwen2-1.5b", False, dict(ENGINE, paged=False, eos_id=NO_EOS,
                                                       clock=clock), group, world)
        log = terminations(eng)
        lead_or_follow(eng, lambda e: [e.submit(p, max_new=30, timeout=t)
                                       for p, t in zip(PROMPTS, (0.4, 100.0, 0.05))])
        out["deadlines"] = sorted(log)

        # the leader's chaos schedule
        chaos = ChaosMonkey(3, cancel_prob=0.2, deadline_prob=0.2, pressure_prob=0.5) \
            if group.leader else None
        eng, _ = port_engine("qwen2-1.5b", False, dict(ENGINE, paged=True, eos_id=NO_EOS,
                                                       num_blocks=10, chaos=chaos,
                                                       clock=Ticks(0.001)), group, world)
        log = terminations(eng)
        lead_or_follow(eng, lambda e: [e.submit(p + [7] * i, max_new=12)
                                       for i in range(2) for p in PROMPTS])
        out["chaos"] = {"log": sorted(log), "drained": eng.kv.drained(),
                        "injected": None if chaos is None else dict(chaos.injected)}
        return out
    finally:
        close_tp()


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(engine_rank, 2, timeout=300)


def test_tp2_invariants_on_every_rank(ranks):
    world = j_world("qwen2-1.5b")
    tp1, _ = port_engine("qwen2-1.5b", False, dict(ENGINE, paged=True), None, world)
    for rank, out in enumerate(ranks):
        inv = out["invariants"]
        assert inv["fetches"] == inv["transfers"] == inv["steps"] > 0, (rank, inv)
        assert inv["total"] == tp1.kv.pool_bytes()
        assert inv["shard"] * 2 == inv["total"]
        assert inv["g_tp"] == 2 and inv["g_shard"] == inv["shard"]


def test_tenant_straddling_both_ranks_serves_reference_tokens(ranks):
    world = j_world("qwen2-1.5b")
    _, model, params, _ = world
    store = JStore()
    store.register(*straddling_tenant(world))
    eng = JEngine(model, params, adapter_store=store, quant_block=32, paged=True, **ENGINE)
    for p in PROMPTS:
        eng.submit(p, max_new=6, adapter_id=1)
    want = [r.out for r in sorted(eng.run_to_completion(), key=lambda r: r.rid)]
    for rank, out in enumerate(ranks):
        assert [o for _, _, o in out["straddle"]] == want, rank


def test_sampled_tokens_are_the_same_on_every_rank(ranks):
    leader = ranks[0]["sampled"]
    assert len(leader) == len(PROMPTS) and all(len(o) == 10 for _, _, o in leader)
    assert ranks[1]["sampled"] == leader


def test_deadlines_on_the_leaders_clock_expire_on_every_rank(ranks):
    leader = ranks[0]["deadlines"]
    reasons = [reason for _, reason, _ in leader]
    assert reasons.count("deadline") == 2 and "max_new" in reasons, leader
    assert ranks[1]["deadlines"] == leader


def test_leaders_chaos_replays_on_every_rank(ranks):
    leader = ranks[0]["chaos"]
    assert sum(leader["injected"].values()) > 0, leader
    assert ranks[1]["chaos"]["log"] == leader["log"]
    assert leader["drained"] and ranks[1]["chaos"]["drained"]
