"""Greedy serving of olmoe on a packed (int8 / NF4) frozen base in the port
against the JAX reference, on the CPU.

Reduced olmoe-1b-7b in fp32 (2 layers, 4 experts top-2, untied head), the
reference's params packed by each package (byte-identical, see
``test_torch_moe_quant.py``), two NeuroAda tenants on indices selected on
the packed base: greedy tokens equal ``repro.serve.ServeEngine(base_dtype)``
token for token on the paged pool and the dense cache, and with the int8
self-drafter (its drafts and acceptances too). The attention projections
and the head run the packed kernel's plain version; the expert stacks are
dequantized per call.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.models import get_model as j_get_model
from repro.peft import quantize_base as j_quantize_base
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import to_numpy, tree_to_torch
from repro_torch.core.adapt import init_adapters
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.models import get_model
from repro_torch.peft import quantize_base
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.tree import map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
BLOCK = 32
NO_EOS = 1 << 20
BASES = ["int8", "nf4"]


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("olmoe-1b-7b")).replace(dtype="float32", num_layers=2)
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("olmoe-1b-7b")).replace(dtype="float32",
                                                                 num_layers=2))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (4, 21, 9, 30)]
    out = {"cfg": cfg, "jm": jm, "tm": tm, "prompts": prompts}
    for base in BASES:
        tq = quantize_base(tree_to_torch(np_tree(jp)), base, block=BLOCK)
        idx, val = init_adapters(tq, 2)
        idx = map_leaves(lambda i: None if i is None else to_numpy(i), idx)
        tenants = [(idx, map_leaves(lambda v: None if v is None else
                                    (0.05 * (s + 1) * rng.standard_normal(v.shape)).astype(
                                        np.float32), val)) for s in range(2)]
        out[base] = {"jp": j_quantize_base(jp, base, block=BLOCK), "tp": tq,
                     "tenants": tenants}
    return out


def serve(world, base, port: bool, tenants: bool, **kw):
    w = world[base]
    store = None
    if tenants:
        store = AdapterStore() if port else JStore()
        for idx, val in w["tenants"]:
            store.register(*((tree_to_torch(idx), tree_to_torch(val)) if port else (idx, val)))
    kw = {"slots": 2, "max_len": 64, "eos_id": NO_EOS, "prefill_chunk": 8, "decode_chunk": 4,
          "paged": True, **kw}
    eng = (ServeEngine(world["tm"], w["tp"], adapter_store=store, device="cpu", **kw) if port
           else JEngine(world["jm"], w["jp"], adapter_store=store, **kw))
    for i, (p, mn) in enumerate(zip(world["prompts"], (5, 8, 3, 6))):
        eng.submit(p, max_new=mn, adapter_id=i % 3 if tenants else 0)
    return [r.out for r in sorted(eng.run_to_completion(), key=lambda r: r.rid)], eng


CASES = {
    "paged_tenants": dict(tenants=True),
    "dense_tenants": dict(tenants=True, paged=False),
    "int8_drafter": dict(tenants=False, draft="int8", spec_k=3),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("base", BASES)
def test_greedy_serving_matches_the_reference(world, base, case):
    kw = dict(CASES[case])
    want, je = serve(world, base, False, **kw)
    reset_counters()
    got, te = serve(world, base, True, **kw)
    assert got == want
    assert COUNTERS["fused_linear_q"].plain > 0  # attention and head on the packed kernel
    if "draft" in kw:
        assert (te.spec_drafted, te.spec_accepted) == (je.spec_drafted, je.spec_accepted)
        assert te.spec_drafted > 0
