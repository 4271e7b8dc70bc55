"""int8 KV on the MoE family in the port against the JAX reference, on the
CPU.

Reduced olmoe-1b-7b in fp32 (4 experts top-2, 4/4 heads: GQA group 1), the
reference's params and two random NeuroAda tenants converted leaf by leaf:
greedy tokens of ``ServeEngine(kv_dtype="int8")`` equal
``repro.serve.ServeEngine(kv_dtype="int8")`` token for token on the paged
pool and on the dense cache, with decode chunks 1 and 4, mixed steps wide
enough for capacity drops and a packed base under the int8 pool; the
pools' bytes equal the reference's and drain (the int8 self-drafter on a
packed olmoe base is in ``test_torch_moe_quant_serve.py``). Each
layer-forward runs the int8 attention bodies (their plain versions here).
The launcher serves olmoe with ``--kv-dtype int8`` on both caches.
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
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.launch import serve as launch
from repro_torch.models import get_model
from repro_torch.serve import AdapterStore, ServeEngine

torch.set_num_threads(2)
NO_EOS = 1 << 20
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("olmoe-1b-7b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(3))
    tm = get_model(t_reduced(t_get_config("olmoe-1b-7b")).replace(dtype="float32"))
    rng = np.random.default_rng(5)
    tenants = []
    for _ in range(2):
        idx, val = jax.jit(lambda p: j_init_adapters(p, 2))(jp)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (4, 21, 9, 30, 3)]
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "tenants": tenants, "prompts": prompts}


def serve(world, port: bool, tenants: bool, max_new=(3, 7, 12, 5, 9), **kw):
    store = None
    if tenants:
        store = AdapterStore() if port else JStore()
        for idx, val in world["tenants"]:
            store.register(*((tree_to_torch(idx), tree_to_torch(val)) if port else (idx, val)))
    kw = {"slots": 2, "max_len": 64, "eos_id": NO_EOS, "prefill_chunk": 8, "decode_chunk": 4,
          "kv_dtype": "int8", **kw}
    eng = (ServeEngine(world["tm"], world["tp"], adapter_store=store, device="cpu", **kw)
           if port else JEngine(world["jm"], world["jp"], adapter_store=store, **kw))
    for i, (p, mn) in enumerate(zip(world["prompts"], max_new)):
        eng.submit(p, max_new=mn, adapter_id=i % 3 if tenants else 0)
    return [r.out for r in sorted(eng.run_to_completion(), key=lambda r: r.rid)], eng


CASES = {
    "paged_tenants": dict(tenants=True, paged=True),
    "dense_tenants": dict(tenants=True, paged=False),
    "dense_base_decode1": dict(tenants=False, paged=False, decode_chunk=1),
    # (3, 16) mixed steps: capacity drops, idle slots competing for experts
    "paged_int8_base_wide": dict(tenants=True, paged=True, base_dtype="int8", quant_block=32,
                                 slots=3, prefill_chunk=16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_the_reference_int8_engine(world, case):
    kw = dict(CASES[case])
    want, je = serve(world, False, **kw)
    reset_counters()
    got, te = serve(world, True, **kw)
    assert got == want
    assert te.kv.pool_bytes() == int(je.kv.pool_bytes())
    assert te.kv.drained()
    bodies = (("paged_decode_attention_q", "paged_prefill_attention_q") if kw["paged"]
              else ("decode_attention_q",))
    assert all(COUNTERS[b].plain > 0 for b in bodies)


@pytest.mark.parametrize("layout", [[], ["--dense"]])
def test_launcher_serves_olmoe_on_int8_kv(layout, capsys):
    launch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--kv-dtype", "int8",
                 "--max-new", "3", *layout])
    out = capsys.readouterr().out
    assert f"kv={'dense' if layout else 'paged'}/int8" in out and "req1 [base]" in out
