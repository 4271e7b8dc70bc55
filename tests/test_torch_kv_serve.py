"""The port's engine on an int8 KV cache and on the dense slot cache against
the JAX reference, on the CPU.

Greedy tokens from ``repro_torch.serve.ServeEngine`` (plain versions of the
kernels) must equal ``repro.serve.ServeEngine``'s token for token, over the
same converted fp32 weights and tenants: the paged engine with int8 KV
(plain, multi-tenant, on an int8 base) and the dense engine with fp and
int8 KV (plain and multi-tenant), prompts over several chunks, ``decode_chunk``
4, one transfer per step, every slot or block handed back. Each run
launches only the attention bodies of its own layout and dtype. Also: the
paged and dense int8 engines agree token for token (the reference's
``test_paged_and_dense_int8_identical``), a mid-prefill preemption on an
int8 pool re-prefills to the same tokens (its
``test_int8_mid_prefill_preemption_exact``), ``pool_bytes`` equals the
reference's, and the launcher's new flags.

The int8 engines are held against the reference's int8 tokens, not against
a drift budget from the fp32 cache (which the reference itself misses on
this config).
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
from repro_torch.kernels import ATTENTION, COUNTERS, reset_counters
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
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
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
            "tenants": tenants, "prompts": prompts}


def serve(world, port: bool, *, tenants=False, prompts=None, max_new=(3, 7, 12, 5, 9),
          **kw):
    """One engine over the world's requests; returns (outs, engine)."""
    prompts = world["prompts"] if prompts is None else prompts
    n_ad = len(world["tenants"]) if tenants else 0
    store = None
    if n_ad:
        store = AdapterStore() if port else JStore()
        for idx, val in world["tenants"]:
            if port:
                idx, val = tree_to_torch(idx), tree_to_torch(val)
            store.register(idx, val)
    kw = {"slots": 2, "max_len": 64, "eos_id": NO_EOS, "prefill_chunk": 8,
          "decode_chunk": 4, **kw}
    if port:
        eng = ServeEngine(world["tm"], world["tp"], adapter_store=store, device="cpu", **kw)
    else:
        eng = JEngine(world["jm"], world["jp"], adapter_store=store, **kw)
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        eng.submit(p, max_new=mn, adapter_id=i % (n_ad + 1))
    return [r.out for r in sorted(eng.run_to_completion(), key=lambda r: r.rid)], eng


CASES = {
    "paged_int8_plain": dict(paged=True, kv_dtype="int8"),
    "paged_int8_tenants": dict(paged=True, kv_dtype="int8", tenants=True),
    "paged_int8_int8base": dict(paged=True, kv_dtype="int8", base_dtype="int8",
                                quant_block=32),
    "dense_fp_plain": dict(paged=False, kv_dtype="fp32"),
    "dense_fp_tenants": dict(paged=False, kv_dtype="fp32", tenants=True),
    "dense_int8_plain": dict(paged=False, kv_dtype="int8"),
    "dense_int8_tenants": dict(paged=False, kv_dtype="int8", tenants=True),
}


@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_match_reference(world, case):
    kw = CASES[case]
    want, je = serve(world, False, **kw)
    reset_counters()
    got, te = serve(world, True, **kw)
    assert got == want
    assert [len(o) for o in got] == [3, 7, 12, 5, 9]
    assert te.transfers == te.steps == je.transfers
    # the reference's dense cache copies an evicted slot's stale device
    # position back into its host mirror, so only its pool is checked
    assert te.kv.drained() and (je.kv.drained() or not kw["paged"])
    assert te.step_times["mixed"] and te.step_times["decode"]
    # only this layout's and dtype's attention bodies ran
    mine = ATTENTION[(kw["paged"], kw["kv_dtype"])]
    others = {n for names in ATTENTION.values() for n in names} - set(mine)
    assert all(COUNTERS[n].plain > 0 for n in mine)
    assert all(COUNTERS[n].plain == COUNTERS[n].kernel == 0 for n in others)
    assert (COUNTERS["sparse_delta_batched"].plain > 0) == kw.get("tenants", False)
    assert (COUNTERS["fused_linear_q"].plain > 0) == ("base_dtype" in kw)


def test_paged_and_dense_int8_identical(world):
    """Page size 16 = the dense cache's scale group: both layouts quantize
    on the same boundaries, so the tokens agree exactly (the reference's
    test of the same name, here on the port)."""
    paged, _ = serve(world, True, paged=True, kv_dtype="int8", page_size=16)
    dense, _ = serve(world, True, paged=False, kv_dtype="int8")
    assert paged == dense


def test_int8_mid_prefill_preemption_exact(world):
    """Two 4-token decoders and a 44-token prompt fill a 16-block pool of
    4-token pages exactly; a decoder's third page preempts the long request
    mid-prefill. It re-prefills through the same chunk boundaries, so its
    tokens equal the uncontended run's (and the reference's), and the pool
    drains."""
    long_prompt = list(range(1, 45))

    def run(port: bool, contended: bool):
        prompts = ([[2, 3, 4, 5], [6, 7, 8, 9]] if contended else []) + [long_prompt]
        max_new = ((12, 12) if contended else ()) + (6,)
        return serve(world, port, prompts=prompts, max_new=max_new,
                     slots=3 if contended else 1, paged=True, page_size=4, num_blocks=16,
                     kv_dtype="int8")

    want, _ = run(True, False)
    got, te = run(True, True)
    ref, je = run(False, True)
    assert te.preemptions_mid_prefill >= 1
    assert te.preemptions_mid_prefill == je.preemptions_mid_prefill
    assert got[-1] == want[0]
    assert got == ref
    assert te.kv.drained()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_pool_bytes_match_reference(world, paged, kv_dtype):
    kw = {"slots": 3, "max_len": 40, "paged": paged, "kv_dtype": kv_dtype}
    if paged:
        kw.update(page_size=8, num_blocks=17)
    je = JEngine(world["jm"], world["jp"], **kw)
    te = ServeEngine(world["tm"], world["tp"], device="cpu", **kw)
    assert te.kv.pool_bytes() == je.kv.pool_bytes() > 0


def test_engine_rejects_a_bad_kv_dtype(world):
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(world["tm"], world["tp"], device="cpu", kv_dtype="fp8")


# --------------------------------------------------------------- launcher


@pytest.mark.parametrize("argv", [
    ["--dense", "--paged"], ["--dense", "--page-size", "16"],
    ["--dense", "--num-blocks", "64"],
])
def test_launcher_refuses_paged_flags_with_dense(argv):
    with pytest.raises(SystemExit, match="--paged and --dense|paged-engine flag"):
        launch.validate_args(launch.build_parser().parse_args(["--device", "cpu", *argv]))


@pytest.mark.parametrize("argv", [["--kv-dtype", "int8"], ["--dense"],
                                  ["--dense", "--kv-dtype", "int8"]])
def test_launcher_serves_each_cache(argv, capsys):
    launch.main(["--reduced", "--device", "cpu", "--prompts", "1,17,25;1,40,41,42",
                 "--max-new", "3", "--prefill-chunk", "4", *argv])
    out = capsys.readouterr().out
    layout = "dense" if "--dense" in argv else "paged"
    kv = "int8" if "int8" in argv else "fp32"
    assert f"kv={layout}/{kv} pool_bytes=" in out and "req1 [base]" in out
