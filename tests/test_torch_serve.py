"""The port's paged multi-tenant engine against the JAX reference.

Greedy tokens from ``repro_torch.serve.ServeEngine`` on the CPU (plain
versions of the kernels) must equal ``repro.serve.ServeEngine(paged=True)``
token for token, over the same converted fp32 weights and tenants: plain
and multi-tenant, prompts spanning several chunks (``prefill_chunk=8``),
``decode_chunk`` 1 and 4, stops by EOS, ``max_new`` and a full cache,
preemption under a tight pool and same-tenant prefix sharing. Every run
costs one device-to-host transfer per step and hands every block back.
Also: the sampler's filters, adapter files across packages, the launcher.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.models import get_model as j_get_model
from repro.peft import export_adapter as j_export_adapter
from repro.peft import load_adapter as j_load_adapter
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro.serve.sampler import Sampler as JSampler
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.launch import serve as launch
from repro_torch.models import get_model
from repro_torch.peft import export_adapter, load_adapter
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.serve.sampler import Sampler

torch.set_num_threads(2)
NO_EOS = 1 << 20
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jmodel = j_get_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    tparams = tree_to_torch(np_tree(jparams))
    rng = np.random.default_rng(5)
    tenants = []
    for _ in range(2):
        idx, val = j_init_adapters(jparams, 2)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (4, 21, 9, 30, 3)]
    return {"cfg": cfg, "jm": jmodel, "jp": jparams, "tm": tmodel, "tp": tparams,
            "tenants": tenants, "prompts": prompts}


def run_pair(world, *, tenants=False, prompts=None, max_new=(3, 7, 12, 5, 9), ids=None,
             **kw):
    """The same requests through both engines; returns (jax outs, port outs,
    jax engine, port engine)."""
    prompts = world["prompts"] if prompts is None else prompts
    n_ad = len(world["tenants"]) if tenants else 0
    ids = [i % (n_ad + 1) for i in range(len(prompts))] if ids is None else ids
    kw = {"slots": 2, "max_len": 64, "eos_id": NO_EOS, "prefill_chunk": 8, **kw}
    outs = []
    for engine, model, params, extra in (
            (JEngine, world["jm"], world["jp"], {"paged": True}),
            (ServeEngine, world["tm"], world["tp"], {"device": "cpu"})):
        store = None
        if n_ad:
            store = JStore() if engine is JEngine else AdapterStore()
            for idx, val in world["tenants"]:
                if engine is ServeEngine:
                    idx, val = tree_to_torch(idx), tree_to_torch(val)
                store.register(idx, val)
        eng = engine(model, params, adapter_store=store, **extra, **kw)
        for p, mn, aid in zip(prompts, max_new, ids):
            eng.submit(p, max_new=mn, adapter_id=aid)
        reqs = eng.run_to_completion()
        outs.append(([r.out for r in reqs], eng, reqs))
    (jo, je, _), (to, te, treqs) = outs
    assert te.transfers == te.steps == je.transfers, (te.transfers, te.steps, je.transfers)
    assert te.kv.drained() and je.kv.drained()
    assert all(r.done for r in treqs)
    return jo, to, je, te


@pytest.mark.parametrize("tenants", [False, True], ids=["plain", "multi_tenant"])
@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_greedy_tokens_match_reference(world, tenants, decode_chunk):
    jo, to, _, te = run_pair(world, tenants=tenants, decode_chunk=decode_chunk)
    assert to == jo
    assert [len(o) for o in to] == [3, 7, 12, 5, 9]
    assert te.step_times["mixed"] and te.step_times["decode"]


def test_eos_stop_matches_reference(world):
    store = AdapterStore()
    for idx, val in world["tenants"]:
        store.register(tree_to_torch(idx), tree_to_torch(val))
    eng = ServeEngine(world["tm"], world["tp"], adapter_store=store, device="cpu", slots=2,
                      max_len=64, eos_id=NO_EOS, prefill_chunk=8, decode_chunk=4)
    eng.submit(world["prompts"][2], max_new=12, adapter_id=2)
    eos = eng.run_to_completion()[0].out[4]  # a token emitted mid-stream
    jo, to, _, te = run_pair(world, tenants=True, decode_chunk=4, eos_id=eos)
    assert to == jo
    assert any(o and o[-1] == eos and len(o) < mn for o, mn in zip(to, (3, 7, 12, 5, 9)))


def test_full_cache_stop_matches_reference(world):
    prompts = [p[:18] for p in world["prompts"]]
    jo, to, _, te = run_pair(world, tenants=True, prompts=prompts, max_new=(30,) * 5,
                             max_len=24, decode_chunk=4, page_size=4)
    assert to == jo
    assert all(len(p) + len(o) == 24 for p, o in zip(prompts, to))


def test_preemption_under_a_tight_pool_matches_reference(world):
    prompts = [[1, 5, 9, 2], [1, 6, 9, 2], [1, 7, 9, 2]]
    jo, to, je, te = run_pair(world, prompts=prompts, max_new=(20, 20, 20), slots=3,
                              decode_chunk=4, page_size=4, num_blocks=16)
    assert to == jo
    assert te.preemptions >= 1 and te.preemptions == je.preemptions


def test_same_tenant_prefix_sharing_matches_reference(world):
    shared = world["prompts"][3][:8]  # two full pages of 4
    prompts = [shared + [7, 8, 9], shared + [11], shared + [5, 6], shared[:5]]
    jo, to, je, te = run_pair(world, tenants=True, prompts=prompts, max_new=(6, 6, 6, 6),
                              ids=[1, 1, 1, 2], slots=4, decode_chunk=4, page_size=4)
    assert to == jo
    assert te.kv.prefix_page_hits > 0
    assert te.kv.prefix_page_hits == je.kv.prefix_page_hits


def test_one_host_transfer_per_step_and_no_other_sync(world, monkeypatch):
    calls = {"cpu": 0}
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        calls["cpu"] += 1
        return real_cpu(self, *a, **k)

    def forbidden(self, *a, **k):
        raise AssertionError("host synchronisation inside a serving step")

    store = AdapterStore()
    for idx, val in world["tenants"]:
        store.register(tree_to_torch(idx), tree_to_torch(val))
    eng = ServeEngine(world["tm"], world["tp"], adapter_store=store, device="cpu", slots=2,
                      max_len=64, eos_id=NO_EOS, prefill_chunk=8, decode_chunk=4)
    for i, p in enumerate(world["prompts"]):
        eng.submit(p, max_new=6, adapter_id=i % 3)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", forbidden)
    monkeypatch.setattr(torch.Tensor, "tolist", forbidden)
    eng.run_to_completion()
    assert calls["cpu"] == eng.steps == eng.transfers > 0


def test_idle_slot_decode_frontier_is_zero(world, monkeypatch):
    """A request that finishes mid-megastep stops reading the pool at once:
    each decode iteration attends a slot only while that slot emits, and an
    evicted slot's device position is back to 0."""
    from repro_torch.kernels import ops

    frontiers = []
    real = ops.paged_decode_attention

    def recording(q, k_pool, v_pool, table, kv_valid_len, *scales):
        frontiers.append(kv_valid_len.clone())
        return real(q, k_pool, v_pool, table, kv_valid_len, *scales)

    monkeypatch.setattr(ops, "paged_decode_attention", recording)
    eng = ServeEngine(world["tm"], world["tp"], device="cpu", slots=2, max_len=64,
                      eos_id=NO_EOS, prefill_chunk=16, decode_chunk=4)
    eng.submit(world["prompts"][0], max_new=2)
    eng.submit(world["prompts"][2], max_new=12)
    reqs = eng.run_to_completion()
    layers = world["tm"].cfg.num_layers
    attended = (torch.stack(frontiers) > 0).sum(0).tolist()
    # the first token comes from the mixed step, every later one from one
    # decode iteration of L layer calls
    assert sorted(n // layers for n in attended) == sorted(len(r.out) - 1 for r in reqs)
    assert eng.kv.pos.tolist() == [0, 0]
    assert eng.kv.drained()


# ---------------------------------------------------------------- sampler


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8), (7, 0.6)])
def test_sampler_filters_match_reference(top_k, top_p):
    rng = np.random.default_rng(top_k + int(top_p * 10))
    logits = rng.normal(size=(4, 128)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    js, ts = JSampler(100, top_k=top_k, top_p=top_p), Sampler(100, top_k=top_k, top_p=top_p)
    jscaled, jgreedy = js._filtered(jnp.asarray(logits), jnp.asarray(temps))
    tscaled, tgreedy = ts._filtered(torch.from_numpy(logits), torch.from_numpy(temps))
    np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))
    np.testing.assert_array_equal(np.isinf(tscaled.numpy()), np.isinf(np.asarray(jscaled)))
    finite = np.isfinite(np.asarray(jscaled))
    np.testing.assert_allclose(tscaled.numpy()[finite], np.asarray(jscaled)[finite], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    toks = ts(torch.from_numpy(logits), torch.from_numpy(temps), gen).numpy()
    assert toks[0] == np.asarray(jgreedy)[0]
    assert all(finite[r, toks[r]] for r in range(4))
    again = ts(torch.from_numpy(logits), torch.from_numpy(temps),
               torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(toks, again)


def test_sampler_rejects_bad_settings():
    with pytest.raises(ValueError):
        Sampler(10, top_p=1.5)
    with pytest.raises(ValueError):
        Sampler(10, top_k=-1)


# ---------------------------------------------------------- adapter files


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_reference_adapter_files_load_and_serve(world, tmp_path, dtype):
    idx, val = world["tenants"][0]
    jval = jax.tree.map(lambda v: None if v is None else jnp.asarray(v, dtype), val,
                        is_leaf=NONE)
    path = str(tmp_path / "tenant.npz")
    j_export_adapter(path, idx, jval, metadata={"k": 2})
    lidx, lval = load_adapter(path)
    leaf = lval["blocks"]["wup"]["w"]
    want = np.asarray(jval["blocks"]["wup"]["w"], np.float32)
    assert leaf.dtype == (torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)
    np.testing.assert_array_equal(leaf.float().numpy(), want)
    np.testing.assert_array_equal(lidx["blocks"]["wup"]["w"].numpy(),
                                  idx["blocks"]["wup"]["w"])
    outs = []
    for tree in ((lidx, lval), (tree_to_torch(idx), tree_to_torch(jval))):
        store = AdapterStore(base_params=world["tp"])
        store.register(*tree)
        eng = ServeEngine(world["tm"], world["tp"], adapter_store=store, device="cpu",
                          slots=2, max_len=32, eos_id=NO_EOS, decode_chunk=4)
        eng.submit(world["prompts"][1], max_new=5, adapter_id=1)
        outs.append(eng.run_to_completion()[0].out)
    assert outs[0] == outs[1]


def test_port_adapter_files_load_in_the_reference(world, tmp_path):
    idx, val = tree_to_torch(world["tenants"][1][0]), tree_to_torch(world["tenants"][1][1])
    val = {**val, "blocks": {**val["blocks"], "wq": {
        "w": val["blocks"]["wq"]["w"].to(torch.bfloat16), "b": None}}}
    path = str(tmp_path / "port.npz")
    export_adapter(path, idx, val)
    jidx, jval = j_load_adapter(path)
    assert jval["blocks"]["wq"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jval["blocks"]["wq"]["w"], np.float32),
                                  val["blocks"]["wq"]["w"].float().numpy())
    np.testing.assert_array_equal(np.asarray(jidx["blocks"]["wdown"]["w"]),
                                  idx["blocks"]["wdown"]["w"].numpy())


def test_store_rejects_mismatched_or_foreign_adapters(world):
    idx, val = world["tenants"][0]
    store = AdapterStore(base_params=world["tp"])
    bad_idx = tree_to_torch(idx)
    bad_idx["blocks"]["wq"]["w"] = bad_idx["blocks"]["wq"]["w"] + 10_000
    with pytest.raises(ValueError, match="out of range"):
        store.register(bad_idx, tree_to_torch(val))
    short = tree_to_torch(val)
    short["blocks"]["wq"]["w"] = short["blocks"]["wq"]["w"][..., :1, :]
    with pytest.raises(ValueError, match="mirror"):
        store.register(tree_to_torch(idx), short)
    with pytest.raises(ValueError, match="blocks"):
        store.register({"head": None}, {"head": None})
    assert store.register(tree_to_torch(idx), tree_to_torch(val)) == 1
    store.remove(1)
    assert store.num_adapters == 0 and store.stacked("cpu") is None


def test_submit_validates_requests(world):
    eng = ServeEngine(world["tm"], world["tp"], device="cpu", slots=1, max_len=16)
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit([1] * 16)
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new=0)
    with pytest.raises(ValueError):
        eng.submit([1, 2], adapter_id=1)
    with pytest.raises(ValueError):
        eng.submit([1, 2], temperature=float("nan"))
    with pytest.raises(ValueError):
        ServeEngine(world["tm"], world["tp"], device="cpu", page_size=12)


# --------------------------------------------------------------- launcher


@pytest.mark.parametrize("argv", [
    ["--decode-chunk", "0"], ["--prefill-chunk", "0"], ["--max-new", "0"],
    ["--page-size", "12"], ["--max-len", "128", "--num-blocks", "3"],
    ["--prompts", ";"], ["--prompts", "1,2;3", "--adapter-ids", "0"],
    ["--top-p", "1.5"], ["--slots", "0"],
])
def test_launcher_rejects_bad_flags(argv):
    with pytest.raises(SystemExit):
        launch.validate_args(launch.build_parser().parse_args(["--device", "cpu", *argv]))


def test_launcher_serves_tenants_on_the_cpu(world, tmp_path, capsys):
    idx, val = world["tenants"][0]
    path = str(tmp_path / "a.npz")
    j_export_adapter(path, idx, val)
    launch.main(["--reduced", "--device", "cpu", "--prompts", "1,17,25;1,40,41,42",
                 "--max-new", "3", "--adapters", path, "--adapter-ids", "1,0",
                 "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "req0 [tenant1]" in out and "req1 [base]" in out and "device=cpu" in out
