"""The port's ``serve_batched`` twin against the reference's
``examples/serve_batched.py`` on the CPU.

``reference_serve_batched`` repeats the reference's body (lines 31-153)
at its own sizes — reduced qwen2.5-3b at 4 layers on an int8 base, two
tenants, the paged int8-KV engine with 6 slots, ``max_len`` 128, pages of
16, 32 blocks, prefill chunk 16, decode chunk 8, metrics and a tracer, the
six prompts and tenant ids, then the merged-drafter twin at 48 blocks —
with the model in float32 (every parity test of the port holds float32)
and the reference's params in place of its ``model.init``. The tenants are
drawn by JAX as the reference draws them and handed, converted, to the
twin's ``run(tenants=...)``; each package packs the same dense params with
its own ``quantize_base``.

Held: identical greedy tokens for all six requests on both engines, the
blocks in use and shared after the admission steps, the tenant token
split, the prefix hit and fresh counts, the speculative twin's accepted and
drafted counts; and on the twin one transfer a step, the pool drained, and
the path's plain versions called (the kernels the card's run launches).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.models import get_model as j_get_model
from repro.obs import Tracer as JTracer
from repro.peft import quantize_base as j_quantize_base
from repro.quant import tree_bytes as j_tree_bytes
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro_torch.convert import tree_to_torch
from repro_torch.examples import serve_batched
from repro_torch.kernels import COUNTERS, reset_counters

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def reference_serve_batched(cfg, params) -> dict:
    """The reference's ``examples/serve_batched.py:31-153`` on ``params``,
    returning the twin's figures and the tenants it drew."""
    model = j_get_model(cfg)  # :32
    out = {"dense_bytes": j_tree_bytes(params)}  # :35-36
    params = j_quantize_base(params, "int8")
    out["packed_bytes"] = j_tree_bytes(params)
    store = JStore(base_params=params)  # :43-50
    tenants = []
    for seed in (1, 2):
        idx, val = j_init_adapters(params, 2, rng=jax.random.PRNGKey(seed))
        val = jax.tree.map(
            lambda i, v: None if v is None else 0.05 * jax.random.normal(
                jax.random.fold_in(jax.random.PRNGKey(seed), v.size), v.shape),
            idx, val, is_leaf=lambda x: x is None)
        store.register(idx, val, name=f"tenant{seed}")
        tenants.append((np_tree(idx), np_tree(val)))
    out["tenant_trees"] = tenants
    engine = JEngine(model, params, slots=6, max_len=128,  # :66-71
                     adapter_store=store, decode_chunk=8, prefill_chunk=16,
                     paged=True, page_size=16, num_blocks=32, kv_dtype="int8",
                     metrics=True, tracer=JTracer())
    prompts, ids = serve_batched.PROMPTS, serve_batched.IDS  # :72-84 (the same lists)
    for p, aid in zip(prompts, ids):  # :86-87
        engine.submit(p, max_new=16, adapter_id=aid)
    steps = 0  # :91-94
    while engine.scheduler.has_queued() or engine.scheduler.has_prefilling():
        engine.step()
        steps += 1
    kv = engine.kv  # :95-100
    out.update(admit_steps=steps, used_blocks=kv.used_blocks,
               shared_pages=int((kv.refcount > 1).sum()))
    reqs = engine.run_to_completion()  # :101
    out["outs"] = {r.rid: list(r.out) for r in reqs}
    out["tenants"] = {r.rid: "base" if r.adapter_id == 0 else store.names[r.adapter_id - 1]
                      for r in reqs}  # :108-110
    reg = engine.metrics  # :116-126
    out["split"] = {t: int(reg.value("serve_tenant_tokens_total", t)) for t in ("0", "1", "2")}
    out.update(prefix_hit=int(reg.value("serve_prefix_pages_hit_total")),
               prefix_fresh=int(reg.value("serve_prefix_pages_fresh_total")),
               trace_events=len(engine.tracer))
    spec = JEngine(model, params, slots=6, max_len=128,  # :137-141
                   adapter_store=store, decode_chunk=8, prefill_chunk=16, paged=True,
                   page_size=16, num_blocks=48, draft="merged", spec_k=4, kv_dtype="int8")
    for p, aid in zip(prompts, ids):  # :142-143
        spec.submit(p, max_new=16, adapter_id=aid)
    spec_reqs = spec.run_to_completion()  # :145
    out["spec_outs"] = {r.rid: list(r.out) for r in spec_reqs}
    out["agreement"] = sum(a == b for rs, rp in zip(spec_reqs, reqs)  # :147-151
                           for a, b in zip(rs.out, rp.out)) / max(
        sum(len(r.out) for r in reqs), 1)
    out.update(spec_accepted=spec.spec_accepted, spec_drafted=spec.spec_drafted)
    return out


@pytest.fixture(scope="module")
def runs():
    cfg = serve_batched.config().replace(dtype="float32")
    jcfg = reduced(get_config("qwen2.5-3b")).replace(num_layers=4, dtype="float32")
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    want = reference_serve_batched(jcfg, jp)
    tenants = [(tree_to_torch(i), tree_to_torch(v)) for i, v in want["tenant_trees"]]
    reset_counters()
    got = serve_batched.run(cfg, tree_to_torch(np_tree(jp)), tenants, device="cpu")
    return want, got, {n: c.plain for n, c in COUNTERS.items()}


def test_serve_batched_tokens_match_reference(runs):
    want, got, _ = runs
    assert sorted(got["outs"]) == list(range(6))
    assert got["outs"] == want["outs"]
    assert got["spec_outs"] == want["spec_outs"]
    assert got["tenants"] == want["tenants"]
    assert all(len(o) == 16 for o in got["outs"].values())


@pytest.mark.parametrize("key", ["dense_bytes", "packed_bytes", "admit_steps", "used_blocks",
                                 "shared_pages", "split", "prefix_hit", "prefix_fresh",
                                 "spec_accepted", "spec_drafted", "agreement", "trace_events"])
def test_serve_batched_figures_match_reference(runs, key):
    want, got, _ = runs
    assert got[key] == want[key]


def test_serve_batched_path(runs):
    """One transfer a step on both engines, the pool drained, and the plain
    versions of the kernels the card's run must launch: the int8 paged
    bodies, the tenants' batched apply, the packed base's linears and the
    drafter's dense decode."""
    _, got, plain = runs
    assert got["transfers"] == got["steps"] and got["spec_transfers"] == got["spec_steps"]
    assert got["free_blocks"] == got["num_blocks"] == 32 and got["shared_pages"] >= 1
    for name in ("paged_prefill_attention_q", "paged_decode_attention_q",
                 "sparse_delta_batched", "fused_linear_q"):
        assert plain[name] > 0, name
    for name in ("paged_prefill_attention", "paged_decode_attention", "fused_linear",
                 "sparse_delta_dval", "topk_select"):
        assert plain[name] == 0, name
