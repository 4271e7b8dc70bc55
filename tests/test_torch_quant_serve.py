"""Greedy serving on a packed (int8 / NF4) frozen base against the JAX
reference, on the CPU.

``repro_torch.serve.ServeEngine(base_dtype=...)`` with the plain versions
of the kernels must give ``repro.serve.ServeEngine(paged=True,
base_dtype=...)``'s greedy tokens, token for token, over the same converted
fp32 weights: base-only and with 3 tenants, ``decode_chunk`` 1 and 4,
blocks of 32 rows. Every base matmul goes through ``fused_linear_q`` (7 per
layer-forward), one transfer per step, and the pool drains.
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
from repro_torch.models import get_model
from repro_torch.quant import QuantizedTensor
from repro_torch.serve import AdapterStore, ServeEngine

torch.set_num_threads(2)
NO_EOS = 1 << 20


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree,
                        is_leaf=lambda x: x is None)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp))}


@pytest.fixture(scope="module")
def tenants(world):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(3):
        idx, val = j_init_adapters(world["jp"], 2)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=lambda x: x is None)
        out.append((np_tree(idx), val))
    return out


@pytest.mark.parametrize("decode_chunk", [1, 4])
@pytest.mark.parametrize("n_tenants", [0, 3], ids=["base", "3_tenants"])
@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_greedy_tokens_on_a_packed_base_match_reference(world, tenants, qdtype, n_tenants,
                                                        decode_chunk):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(3, world["cfg"].vocab_size, size=n).tolist() for n in (4, 19, 9)]
    max_new, ids = (6, 9, 4), [i % (n_tenants + 1) for i in range(3)]
    kw = {"slots": 2, "max_len": 48, "eos_id": NO_EOS, "prefill_chunk": 8,
          "decode_chunk": decode_chunk, "base_dtype": qdtype, "quant_block": 32}
    outs = []
    for engine, store, params, extra in (
            (JEngine, JStore() if n_tenants else None, world["jp"], {"paged": True}),
            (ServeEngine, AdapterStore() if n_tenants else None, world["tp"],
             {"device": "cpu"})):
        for idx, val in tenants[:n_tenants]:
            if engine is ServeEngine:
                idx, val = tree_to_torch(idx), tree_to_torch(val)
            store.register(idx, val)
        reset_counters()
        eng = engine(world["jm"] if engine is JEngine else world["tm"], params,
                     adapter_store=store, **extra, **kw)
        for p, mn, aid in zip(prompts, max_new, ids):
            eng.submit(p, max_new=mn, adapter_id=aid)
        outs.append([r.out for r in eng.run_to_completion()])
    assert outs[1] == outs[0]
    assert [len(o) for o in outs[1]] == list(max_new)
    # every base matmul went through the packed kernel's plain version
    assert COUNTERS["fused_linear_q"].plain > 0
    assert (COUNTERS["fused_linear_q"].plain == 7 * (COUNTERS["paged_decode_attention"].plain
                                                     + COUNTERS["paged_prefill_attention"].plain))
    assert (COUNTERS["sparse_delta_batched"].plain > 0) == (n_tenants > 0)
    assert isinstance(eng.params["blocks"]["wq"]["w"], QuantizedTensor)
    assert eng.transfers == eng.steps and eng.kv.drained()


def test_engine_rejects_a_bad_base_dtype(world):
    with pytest.raises(ValueError, match="base_dtype"):
        ServeEngine(world["tm"], world["tp"], device="cpu", base_dtype="int4")
    with pytest.raises(ValueError, match="block"):
        ServeEngine(world["tm"], world["tp"], device="cpu", base_dtype="int8", quant_block=3)
