"""Tensor-parallel serving: the port's greedy tokens at tp 2 and 4 against
the reference's tp = 1 engine.

Reduced qwen2-1.5b in float32 with ``num_kv_heads=4`` and ``num_heads=8``
(as the reference's ``tests/serve/test_sharded.py`` prelude sizes it, so
tp 4 keeps whole GQA groups), the reference's random params converted leaf
by leaf, its prompts and its engine settings (2 slots, max_len 64,
decode_chunk 2, prefill_chunk 8, 6 new tokens). Every case of its
``_GRID`` — ``paged_plain``, ``dense_plain``, ``paged_mt``, ``paged_int8``,
``paged_spec_int8``, ``dense_ngram``, ``dense_mt_int8`` — plus paged int8
KV and an untied head on an int8 base (reduced qwen3-32b, so
``matmul_q_cols_sharded`` runs) must give ``repro.serve.ServeEngine``'s
tokens at tp = 1. The packed bases use 32-row scale blocks in both
engines: at tp 4 the row-parallel ``wo`` and ``wdown`` (``d_in`` 128) give
each rank 32 rows, and the port refuses a split that cuts a block (the
reference replicates the scales instead). The reference's own tp > 1 runs
fail under this jax (``ShardingTypeError`` at the embedding lookup), so its
tp = 1 engine is the oracle.

The ranks are spawned processes on the CPU (gloo, a ``file://``
rendezvous), every case of one file and one tp in one spawn; the leader
returns the tokens, every rank its transfers and steps (equal, one fetch a
step) and whether its pool drained. This file holds the plain, tenant and
int8 cases; ``test_torch_tp_serve_more.py`` the drafters, the dense int8
base with tenants and the untied head, with these helpers.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.models import get_model as j_get_model
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.distributed.collectives import close_tp, init_tp, run_ranks
from repro_torch.models import get_model
from repro_torch.serve import AdapterStore, ServeEngine

NONE = lambda x: x is None  # noqa: E731
PROMPTS = [[1, 17, 25], [1, 40, 41, 42], [3, 5]]
ENGINE = dict(slots=2, max_len=64, decode_chunk=2, prefill_chunk=8)
BLOCK = 32
CASES = {
    "paged_plain": dict(paged=True),
    "dense_plain": dict(paged=False),
    "paged_mt": dict(paged=True, store=True),
    "paged_int8": dict(paged=True, base_dtype="int8"),
    "paged_spec_int8": dict(paged=True, draft="int8", spec_k=2),
    "dense_ngram": dict(paged=False, draft="ngram", spec_k=2),
    "dense_mt_int8": dict(paged=False, store=True, base_dtype="int8"),
    "paged_int8_kv": dict(paged=True, kv_dtype="int8"),
    "untied_int8": dict(paged=True, store=True, base_dtype="int8", arch="qwen3-32b"),
}


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def j_world(arch: str):
    """(cfg, model, params, tenants) of the reference: the prelude's reduced
    config, params from PRNGKey(0), two tenants of magnitude indices and
    seeded normal values."""
    cfg = reduced(get_config(arch)).replace(dtype="float32", num_kv_heads=4, num_heads=8)
    model = j_get_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tenants = []
    for seed in (1, 2):
        idx, val = j_init_adapters(params, 2)
        rng = np.random.default_rng(seed)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    return cfg, model, params, tenants


def engine_kw(case: dict) -> tuple[str, bool, dict]:
    kw = dict(case)
    arch = kw.pop("arch", "qwen2-1.5b")
    return arch, kw.pop("store", False), {**ENGINE, "quant_block": BLOCK, **kw}


def submit_all(eng, n_tenants: int) -> None:
    for i, p in enumerate(PROMPTS):
        eng.submit(p, max_new=6, adapter_id=1 + i % n_tenants if n_tenants else 0)


def reference_tokens(name: str) -> list:
    arch, with_store, kw = engine_kw(CASES[name])
    _, model, params, tenants = j_world(arch)
    store = None
    if with_store:
        store = JStore()
        for idx, val in tenants:
            store.register(idx, val)
    eng = JEngine(model, params, adapter_store=store, **kw)
    submit_all(eng, len(tenants) if with_store else 0)
    return [r.out for r in sorted(eng.run_to_completion(), key=lambda r: r.rid)]


def port_engine(arch, with_store, kw, group, world=None):
    """The port's engine of one case on one rank (``group`` None: tp = 1)."""
    cfg, _, params, tenants = world if world is not None else j_world(arch)
    model = get_model(t_reduced(t_get_config(arch)).replace(dtype="float32", num_kv_heads=4,
                                                            num_heads=8))
    store = None
    if with_store:
        store = AdapterStore()
        for idx, val in tenants:
            store.register(tree_to_torch(idx), tree_to_torch(val))
    eng = ServeEngine(model, tree_to_torch(np_tree(params)), adapter_store=store,
                      device="cpu", tp_group=group, **kw)
    return eng, len(tenants) if with_store else 0


def serve_case(eng, n_tenants: int):
    """Leader: submit, run, close; follower: follow. Returns (tokens or
    None, transfers, steps, drained)."""
    outs = None
    if eng.tp_group is None or eng.tp_group.leader:
        submit_all(eng, n_tenants)
        reqs = eng.run_to_completion()
        eng.close()
        outs = [r.out for r in sorted(reqs, key=lambda r: r.rid)]
    else:
        eng.follow()
    return outs, eng.transfers, eng.steps, eng.kv.drained()


def grid_rank(rank, tp, init_method, names):
    torch.set_num_threads(1)
    group = init_tp(rank, tp, "cpu", init_method, timeout=120)
    worlds = {}
    try:
        out = {}
        for name in names:
            arch, with_store, kw = engine_kw(CASES[name])
            if arch not in worlds:
                worlds[arch] = j_world(arch)
            eng, n = port_engine(arch, with_store, kw, group, worlds[arch])
            out[name] = serve_case(eng, n)
        return out
    finally:
        close_tp()


FILE_CASES = ("paged_plain", "dense_plain", "paged_mt", "paged_int8", "paged_int8_kv")


class Grid:
    """The reference's tokens and the ranks' results of a file's cases,
    computed once for the module: one spawn a tp."""

    def __init__(self, names):
        self.names = list(names)
        self.want = {name: reference_tokens(name) for name in self.names}
        self.ranks = {}

    def check(self, name: str, tp: int) -> None:
        if tp not in self.ranks:
            self.ranks[tp] = run_ranks(grid_rank, tp, self.names, timeout=600)
        ranks = self.ranks[tp]
        outs, transfers, steps, drained = ranks[0][name]
        assert outs == self.want[name], {"reference tp=1": self.want[name],
                                         f"port tp={tp}": outs}
        for r, res in enumerate(ranks):
            _, t_r, s_r, d_r = res[name]
            assert t_r == s_r == steps and d_r, (name, r, t_r, s_r, steps, d_r)


@pytest.fixture(scope="module")
def grid():
    return Grid(FILE_CASES)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", FILE_CASES)
def test_tp_tokens_match_reference_tp1(grid, name, tp):
    grid.check(name, tp)
