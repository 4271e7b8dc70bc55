"""Expert parallelism in the port's MoE FFN, in one process on the CPU.

Each rank's ``moe_ffn`` runs under a stand-in serving group (the serving
context holds only ``tp`` and ``rank``) on its slices of the params and
tenant stacks (``shard_params``, ``AdapterStore.stacked``), and the ranks'
partial sums add up to the unsharded port's ``moe_ffn``:

* bit for bit in float32 at K = 2 (reduced olmoe-1b-7b, 4 experts, at tp 2
  and 4): a token's two gated outputs land on one or two ranks and every
  other rank adds an exact zero, so the sum is the same single addition;
* at K = 8 (16 experts) within ``(K + tp) u`` of the largest expert output,
  u = 2^-24: each rank sums its choices and the ranks' sums are added, the
  same terms in another order (the gates sum to 1);
* with tenant stacks, and with capacity drops forced by a small
  ``capacity_factor`` (routing stays global, so the drops are the same);
* with 6 experts at tp 4 the experts are replicated: the layer calls no
  all-reduce, and every rank's output is the whole result.

The combined tenant ids of each rank index its own ``(N·E / tp, k, F)``
stack; the plain apply refuses an id past it. A decode step under the
group makes one all-reduce a MoE layer (beside attention's one) and no
all-to-all.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core.adapt import init_adapters
from repro_torch.core.delta import BatchedDelta
from repro_torch.distributed import context as tp_ctx
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import sparse_delta as sd
from repro_torch.models import get_model
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.models.layers import index_tree
from repro_torch.serve import AdapterStore
from repro_torch.tree import map_leaves

torch.set_num_threads(2)
U32 = 2.0 ** -24


class StandInGroup:
    def __init__(self, tp, rank):
        self.tp, self.rank, self.leader = tp, rank, rank == 0


def config(experts=4, k=2, **kw):
    return reduced(get_config("olmoe-1b-7b")).replace(
        dtype="float32", num_experts=experts, experts_per_token=k, num_kv_heads=4,
        num_heads=8, **kw)


def world(cfg, tenants=0):
    """(params, store or None) from seeds: the port's random init and
    ``tenants`` tenants of magnitude indices (k = 2) with seeded normal
    values."""
    params = get_model(cfg).init(seed=0, device="cpu")
    store = None
    if tenants:
        store = AdapterStore()
        for seed in range(1, tenants + 1):
            idx, val = init_adapters(params, 2)
            gen = torch.Generator().manual_seed(seed)
            val = map_leaves(lambda v: None if v is None else
                             0.05 * torch.randn(v.shape, generator=gen), val)
            store.register(idx, val)
    return params, store


def layer_inputs(cfg, params, store, rank, tp, aid, layer=0):
    """(layer params, layer adapters or None) of ``rank`` at ``tp``."""
    shapes = sh.param_shapes(params)
    local = sh.shard_params(params, cfg.family, rank, tp)
    p = index_tree(local["blocks"], layer)
    if store is None:
        return p, None
    sidx, sval = store.stacked("cpu", rank, tp, shapes if tp > 1 else None, cfg.family)
    a = {name: BatchedDelta(sidx["blocks"][name]["w"][layer], sval["blocks"][name]["w"][layer],
                            aid) for name in moe.EXPERT_LINEARS}
    return p, a


def run_rank(cfg, params, store, x, aid, rank, tp):
    """One rank's output under the stand-in group (tp = 1: no group)."""
    p, a = layer_inputs(cfg, params, store, rank, tp, aid)
    snap = tp_ctx.snapshot()
    if tp > 1:
        tp_ctx.set_serve_group(StandInGroup(tp, rank))
    try:
        return moe.moe_ffn(cfg, p, a, x, with_aux=False)[0]
    finally:
        tp_ctx.restore(snap)


def inputs(cfg, b=4, s=6, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    return x, torch.tensor([2, 1, 0, 1][:b], dtype=torch.int32)


def sharded_sum(cfg, params, store, x, aid, tp):
    parts = [run_rank(cfg, params, store, x, aid, r, tp) for r in range(tp)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total, parts


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("tenants", [0, 2])
def test_partial_sums_equal_unsharded_bit_for_bit_at_k2(tp, capacity_factor, tenants):
    cfg = config(capacity_factor=capacity_factor)
    params, store = world(cfg, tenants)
    x, aid = inputs(cfg)
    want = run_rank(cfg, params, store, x, aid, 0, 1)
    got, parts = sharded_sum(cfg, params, store, x, aid, tp)
    assert torch.equal(got, want), float((got - want).abs().max())
    assert all(not torch.equal(p, want) for p in parts)  # each rank holds only a part


def expert_outputs_max(cfg, params, store, x, aid) -> float:
    """max |expert output| of the unsharded run: the scale of the terms the
    combine sums (captured at the combine)."""
    seen = []
    real = moe._combine_group

    def spy(out_e, route, dtype):
        seen.append(float(out_e.abs().max()))
        return real(out_e, route, dtype)

    moe._combine_group = spy
    try:
        run_rank(cfg, params, store, x, aid, 0, 1)
    finally:
        moe._combine_group = real
    return seen[0]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_partial_sums_at_k8_within_the_reordering_bound(tp, capacity_factor):
    cfg = config(experts=16, k=8, capacity_factor=capacity_factor)
    params, store = world(cfg, 2)
    x, aid = inputs(cfg, s=8)
    want = run_rank(cfg, params, store, x, aid, 0, 1)
    got, _ = sharded_sum(cfg, params, store, x, aid, tp)
    # the same K gated terms (gates summing to 1) added in another order
    tol = (cfg.experts_per_token + tp) * U32 * expert_outputs_max(cfg, params, store, x, aid)
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)


def test_replicated_experts_need_no_reducer_and_give_the_whole_result():
    cfg = config(experts=6)
    assert sh.local_experts(6, 0, 4) is None and sh.local_experts(4, 1, 2) == (2, 4)
    params, store = world(cfg, 2)
    x, aid = inputs(cfg)
    want = run_rank(cfg, params, store, x, aid, 0, 1)
    for r in range(4):
        assert torch.equal(run_rank(cfg, params, store, x, aid, r, 4), want), r
    # the MoE layer is handed the all-reduce and calls it only where it
    # split its experts: never at 6 over tp 4, once at 4 over tp 2
    for experts, tp, calls in ((6, 4, 0), (4, 2, 1)):
        c = config(experts=experts)
        p, _ = layer_inputs(c, *world(c), 1, tp, aid)
        seen = []
        snap = tp_ctx.snapshot()
        try:
            tp_ctx.set_serve_group(StandInGroup(tp, 1))
            assert all(r is not None for r in tr._reducers(c))
            moe.moe_ffn(c, p, None, x, with_aux=False, reduce=lambda y: seen.append(y) or y)
        finally:
            tp_ctx.restore(snap)
        assert len(seen) == calls, (experts, tp, len(seen))


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_holds_its_expert_slice_and_local_ids(tp):
    cfg = config()
    params, store = world(cfg, 2)
    x, aid = inputs(cfg)
    e_loc = cfg.num_experts // tp
    n = store.num_adapters + 1
    for r in range(tp):
        p, a = layer_inputs(cfg, params, store, r, tp, aid)
        lo, hi = sh.local_experts(cfg.num_experts, r, tp)
        for name in moe.EXPERT_LINEARS:
            assert p[name]["w"].shape[0] == e_loc
            assert torch.equal(p[name]["w"], params["blocks"][name]["w"][0, lo:hi])
            assert a[name].idx.shape[:2] == (n, e_loc)
        seen = []
        real = moe._dispatch_adapter_ids

        def spy(*args):
            ids = real(*args)
            seen.append(ids)
            return ids

        moe._dispatch_adapter_ids = spy
        snap = tp_ctx.snapshot()
        try:
            tp_ctx.set_serve_group(StandInGroup(tp, r))
            moe.moe_ffn(cfg, p, a, x, with_aux=False)
        finally:
            tp_ctx.restore(snap)
            moe._dispatch_adapter_ids = real
        ids = seen[0]
        assert ids.shape[0] == e_loc
        assert int(ids.min()) >= 0 and int(ids.max()) < n * e_loc
        expert = ids % e_loc  # tenant · (E / tp) + (e − lo)
        assert torch.equal(expert, torch.arange(e_loc)[:, None].expand_as(ids).int())


def test_plain_apply_refuses_an_id_past_the_stacks():
    x = torch.randn(4, 8)
    idx = torch.zeros(3, 1, 5, dtype=torch.int32)
    val = torch.ones(3, 1, 5)
    with pytest.raises(IndexError, match="outside the 3 stacks"):
        sd.sparse_delta_batched(x, idx, val, torch.tensor([0, 1, 2, 3], dtype=torch.int32))


def test_decode_step_makes_one_all_reduce_a_moe_layer_and_no_all_to_all(monkeypatch):
    cfg = config()
    model = get_model(cfg)
    params = model.init(seed=0, device="cpu")
    local = sh.shard_params(params, cfg.family, 0, 2)
    calls = {"all_reduce": 0, "all_gather": 0}

    def all_reduce(x, group):
        calls["all_reduce"] += 1
        return x

    def all_gather(x, group, dim=-1):
        calls["all_gather"] += 1
        return torch.cat([x] * group.tp, dim=dim)

    def refuse(*a, **k):
        raise AssertionError("an all-to-all in the MoE forward")

    monkeypatch.setattr(tr, "tp_all_reduce", all_reduce)
    monkeypatch.setattr(tr, "tp_all_gather", all_gather)
    monkeypatch.setattr(dist, "all_to_all", refuse)
    monkeypatch.setattr(dist, "all_to_all_single", refuse)
    cache = model.init_cache(2, 16, torch.device("cpu"), tp=2)
    batch = {"token": torch.tensor([3, 5], dtype=torch.int32),
             "pos": torch.tensor([0, 0], dtype=torch.int32)}
    snap = tp_ctx.snapshot()
    try:
        tp_ctx.set_serve_group(StandInGroup(2, 0), (cfg.num_heads, cfg.num_kv_heads))
        logits = model.decode_step(local, None, cache, batch)
    finally:
        tp_ctx.restore(snap)
    assert logits.shape == (2, cfg.padded_vocab)
    # wo's and the MoE layer's partial sums: 2 a layer; one gather of the head
    assert calls == {"all_reduce": 2 * cfg.num_layers, "all_gather": 1}
