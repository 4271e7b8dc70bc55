"""Multi-tenant paged serving of the MoE family in the port against the JAX
reference, on the CPU.

Reduced olmoe-1b-7b in fp32 (4 experts top-2, untied head), the
reference's params and two random NeuroAda tenants (expert stacks and head
included) converted leaf by leaf. Greedy tokens of
``repro_torch.serve.ServeEngine`` equal ``repro.serve.ServeEngine`` token
for token: the base alone and with tenants, decode chunks 1 and 4, mixed
steps wide enough that capacity drops occur (idle slots and pad rows route
like any token in both engines), the dense slot cache, and a mid-prefill
preemption under a tight pool. Each layer-forward applies every tenant's
bypass in one ``sparse_delta_batched`` call per projection and per expert
stack, never the training kernel. An adapter trained by the port serves
alike in both engines. The launcher serves olmoe, also on a packed base and
an int8 KV cache (their token parity is in ``test_torch_moe_quant.py`` and
``test_torch_moe_kv.py``).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.models import get_model as j_get_model
from repro.peft import load_adapter as j_load_adapter
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.adapt import init_adapters
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.data import DataLoader
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.launch import serve as launch
from repro_torch.models import get_model
from repro_torch.peft import export_adapter, get_peft, load_adapter
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.serve.sampler import Sampler
from repro_torch.train import Trainer

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
        idx, val = j_init_adapters(jp, 2)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist() for n in (4, 21, 9, 30, 3)]
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "tenants": tenants, "prompts": prompts}


def serve(world, port: bool, *, tenants=None, prompts=None, max_new=(3, 7, 12, 5, 9),
          ids=None, **kw):
    """One engine over the world's requests; returns (outs by rid, engine)."""
    prompts = world["prompts"] if prompts is None else prompts
    tenants = [] if tenants is None else tenants
    store = None
    if tenants:
        store = AdapterStore() if port else JStore()
        for idx, val in tenants:
            if port:
                idx, val = tree_to_torch(idx), tree_to_torch(val)
            store.register(idx, val)
    kw = {"slots": 2, "max_len": 64, "eos_id": NO_EOS, "prefill_chunk": 8,
          "decode_chunk": 4, "paged": True, **kw}
    if port:
        eng = ServeEngine(world["tm"], world["tp"], adapter_store=store, device="cpu", **kw)
    else:
        eng = JEngine(world["jm"], world["jp"], adapter_store=store, **kw)
    ids = [i % (len(tenants) + 1) for i in range(len(prompts))] if ids is None else ids
    for p, mn, aid in zip(prompts, max_new, ids):
        eng.submit(p, max_new=mn, adapter_id=aid)
    return [r.out for r in sorted(eng.run_to_completion(), key=lambda r: r.rid)], eng


CASES = {
    "base_decode4": dict(),
    "tenants_decode1": dict(tenants=True, decode_chunk=1),
    # (3, 16) mixed steps route in 16 groups of 3 tokens, capacity 2 of 6
    # assignments: tokens drop, and idle slots compete with live ones
    "tenants_wide_chunks": dict(tenants=True, slots=3, prefill_chunk=16),
    "tenants_dense_cache": dict(tenants=True, paged=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_reference(world, case):
    kw = dict(CASES[case])
    tenants = world["tenants"] if kw.pop("tenants", False) else None
    want, je = serve(world, False, tenants=tenants, **kw)
    reset_counters()
    got, te = serve(world, True, tenants=tenants, **kw)
    assert got == want
    assert [len(o) for o in got] == [3, 7, 12, 5, 9]
    assert te.transfers == te.steps == je.transfers and te.kv.drained()
    layers = world["cfg"].num_layers
    forwards = len(te.step_times["mixed"]) + te.decode_chunk * len(te.step_times["decode"])
    # 4 attention projections and 3 expert stacks a layer, and the head
    want_calls = (7 * layers + 1) * forwards if tenants else 0
    assert COUNTERS["sparse_delta_batched"].plain == want_calls
    assert COUNTERS["sparse_delta"].plain == COUNTERS["sparse_delta_dval"].plain == 0


def test_mid_prefill_preemption_matches_reference(world):
    """Two 4-token decoders and a 44-token prompt fill a 16-block pool of
    4-token pages; a decoder's third page preempts the long request
    mid-prefill, and it re-prefills. Capacity drops depend on the whole
    step's rows, so the contended run is held against the reference's
    contended run."""
    prompts = [[2, 3, 4, 5], [6, 7, 8, 9], list(range(1, 45))]
    kw = dict(tenants=world["tenants"], prompts=prompts, max_new=(12, 12, 6), slots=3,
              page_size=4, num_blocks=16)
    want, je = serve(world, False, **kw)
    got, te = serve(world, True, **kw)
    assert te.preemptions_mid_prefill >= 1
    assert te.preemptions_mid_prefill == je.preemptions_mid_prefill
    assert got == want
    assert te.kv.drained()


def test_port_trained_adapter_serves_alike_in_both_engines(world, tmp_path):
    trainer = Trainer(world["tm"], get_peft(PeftConfig(k=2)),
                      TrainConfig(steps=3, learning_rate=3e-2), world["tp"])
    data = DataLoader("reasoning", world["cfg"].vocab_size, 4, 16, seed=1)
    try:
        hist = trainer.run(data)
    finally:
        data.close()
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in hist)
    head = trainer.state.trainable["head"]["w"]
    assert float(head.float().abs().max()) > 0  # the untied head trained
    path = str(tmp_path / "tenant.npz")
    export_adapter(path, trainer.aux, trainer.state.trainable, {"arch": "olmoe"})
    outs = []
    for port, adapter in ((False, j_load_adapter(path)), (True, load_adapter(path))):
        store = AdapterStore() if port else JStore()
        assert store.register(*adapter) == 1
        kw = {"slots": 2, "max_len": 48, "eos_id": NO_EOS, "prefill_chunk": 8, "paged": True}
        if port:
            eng = ServeEngine(world["tm"], world["tp"], adapter_store=store, device="cpu", **kw)
        else:
            eng = JEngine(world["jm"], world["jp"], adapter_store=store, **kw)
        for p, aid in zip(world["prompts"][:3], (1, 0, 1)):
            eng.submit(p, max_new=6, adapter_id=aid)
        outs.append([r.out for r in eng.run_to_completion()])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kw", [dict(base_dtype="int8"), dict(kv_dtype="int8")])
def test_engine_refuses_what_moe_does_not_port_yet(world, kw):
    """Nothing is refused on MoE any more: a packed base packs the expert
    stacks (the router stays dense), int8 KV builds int8 pools with scales,
    and an unknown option still raises."""
    from repro_torch.quant import QuantizedTensor

    eng = ServeEngine(world["tm"], world["tp"], device="cpu", **kw)
    blocks = eng.params["blocks"]
    packed = "base_dtype" in kw
    assert isinstance(blocks["wgate"]["w"], QuantizedTensor) == packed
    assert not isinstance(blocks["router"]["w"], QuantizedTensor)
    assert ("k_scale" in eng.kv.data) == ("kv_dtype" in kw)
    with pytest.raises(ValueError):
        ServeEngine(world["tm"], world["tp"], device="cpu", **{k: "int4" for k in kw})


def test_launcher_serves_olmoe_tenants_on_the_cpu(world, tmp_path, capsys):
    from repro.peft import export_adapter as j_export_adapter

    path = str(tmp_path / "a.npz")
    j_export_adapter(path, *world["tenants"][0])
    launch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--prompts",
                 "1,17,25;1,40,41,42", "--max-new", "3", "--adapters", path,
                 "--adapter-ids", "1,0"])
    out = capsys.readouterr().out
    assert "req0 [tenant1]" in out and "req1 [base]" in out and "device=cpu" in out
    for argv, line in ((["--kv-dtype", "int8"], "kv=paged/int8"),
                       (["--base-dtype", "nf4"], "base quantized to nf4")):
        launch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu", "--max-new", "2",
                     *argv])
        assert line in capsys.readouterr().out


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-1.5b"])
def test_cuda_forwards_never_wait_for_the_device(arch, monkeypatch):
    """On the card the engine's fetch is a step's only transfer: every
    forward (mixed chunk and decode megastep, the MoE routing, tenant
    dispatch and expert bypasses included) and every token draw runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a hidden device-to-host
    read (``.item()``, ``bincount``'s range) raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    model = get_model(t_reduced(t_get_config(arch)).replace(dtype="float32"))
    params = model.init(seed=0, device="cuda")
    idx, _ = init_adapters(params, 2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    store = AdapterStore()
    for _ in range(2):
        store.register(idx, jax.tree.map(
            lambda v: None if v is None else
            0.05 * torch.randn(v.shape, generator=gen, device="cuda"), idx, is_leaf=NONE))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, model.cfg.vocab_size, size=n).tolist() for n in (4, 21, 9, 30)]

    def run():
        eng = ServeEngine(model, params, adapter_store=store, device="cuda", slots=2,
                          max_len=64, eos_id=NO_EOS, prefill_chunk=8, decode_chunk=4)
        for i, p in enumerate(prompts):
            eng.submit(p, max_new=6, adapter_id=i % 3)
        return [r.out for r in eng.run_to_completion()], eng

    want, _ = run()  # builds the kernels, outside the guard

    def guarded(fn):
        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    monkeypatch.setattr(model, "prefill_chunk", guarded(model.prefill_chunk))
    monkeypatch.setattr(model, "decode_step", guarded(model.decode_step))
    monkeypatch.setattr(Sampler, "__call__", guarded(Sampler.__call__))
    got, eng = run()
    assert got == want and eng.transfers == eng.steps and eng.kv.drained()
