"""int8 KV on qwen2-vl-2b (the VLM family) in the port's engine against the
reference's engine, on the CPU: reduced qwen2-vl (M-RoPE sections (2, 3,
3), QKV bias, tied embedding) in float32, the reference's params and two
random tenants converted, five text prompts over several chunks (plain
RoPE, as the reference's engine), ``decode_chunk`` 4.

The paged engine on an int8 pool and the dense engine on an int8 slot
cache each give the reference engine's int8 greedy tokens with both
tenants and the base, one transfer a step, every block or slot handed
back, and only their own layout's int8 attention bodies launched (the
paged decode and prefill, or the dense decode); the two layouts give the
same tokens. The int8 engines are held to the reference's int8 tokens, not
to a drift budget from the fp32 cache (ROADMAP §3)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.kernels import ATTENTION, COUNTERS, reset_counters
from repro_torch.models import get_model
from test_torch_kv_serve import np_tree, serve

torch.set_num_threads(2)
ARCH = "qwen2-vl-2b"
NONE = lambda x: x is None  # noqa: E731


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config(ARCH)).replace(dtype="float32"))
    rng = np.random.default_rng(5)
    tenants = []
    for _ in range(2):
        idx, val = j_init_adapters(jp, 2)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (4, 21, 9, 30, 3)]
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "tenants": tenants, "prompts": prompts, "outs": {}}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_int8_kv_greedy_tokens_match_the_reference_engine(world, paged):
    kw = dict(paged=paged, kv_dtype="int8", tenants=True)
    want, je = serve(world, False, **kw)
    reset_counters()
    got, te = serve(world, True, **kw)
    assert got == want
    assert [len(o) for o in got] == [3, 7, 12, 5, 9]
    assert te.transfers == te.steps == je.transfers
    assert te.kv.drained()
    mine = ATTENTION[(paged, "int8")]
    others = {n for names in ATTENTION.values() for n in names} - set(mine)
    assert all(COUNTERS[n].plain > 0 for n in mine)
    assert all(COUNTERS[n].plain == COUNTERS[n].kernel == 0 for n in others)
    world["outs"][paged] = got


def test_paged_and_dense_int8_give_the_same_tokens(world):
    for paged in (True, False):
        if paged not in world["outs"]:
            world["outs"][paged] = serve(world, True, paged=paged, kv_dtype="int8",
                                         tenants=True)[0]
    assert world["outs"][True] == world["outs"][False]
