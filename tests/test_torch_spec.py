"""Speculative decoding in the port against the JAX reference, on the CPU:
the paged pool.

``repro_torch.serve.ServeEngine(draft=..., spec_k=...)`` with the plain
versions of the kernels must give ``repro.serve.ServeEngine``'s greedy
tokens, token for token, and its drafted / accepted / emitted counts, over
the same converted fp32 weights of reduced qwen2-1.5b: every drafter
(int8, nf4, merged, ngram) on the base alone and with two tenants, five
requests on two slots (eviction and re-admission mid-run, max_new landing
mid-round), on the paged pool and the dense cache. Greedy tokens also
equal the port's own ``draft="off"``. This file holds the shared helpers
and the int8 drafter's cases; ``test_torch_spec_{nf4,merged,ngram}.py``
the other drafters' (split so that each file stays short), with EOS and
a full cache landing mid-round; ``test_torch_spec_sampling.py`` the
sampled rounds' distributions, drafter construction and olmoe. A megastep
is one device-to-host transfer; the launcher takes ``--draft`` /
``--spec-k`` and rejects bad ones as the reference's does.
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
from repro_torch.serve import DRAFT_MODES, AdapterStore, DraftKVCache, ServeEngine
from repro_torch.serve.sampler import Sampler

torch.set_num_threads(2)
NO_EOS = 1 << 20
NONE = lambda x: x is None  # noqa: E731
DRAFTERS = ("int8", "nf4", "merged", "ngram")


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
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "tenants": tenants}


def run(world, port: bool, *, draft, n_tenants=0, serve_tenants=None, spec_k=4, chunk=8,
        eos_id=NO_EOS, slots=2, max_len=64, requests=None, paged=True):
    """Serve ``requests`` (default: 5 on 2 slots with max_new 3, 7, 12, 5,
    9) on one engine of either package (the reference's or, with ``port``,
    the port's on the CPU); ``n_tenants`` registered, requests cycling over
    them unless ``serve_tenants`` is False. Returns (tokens, (drafted,
    accepted, emitted), engine)."""
    store = None
    if n_tenants:
        store = AdapterStore() if port else JStore()
        for idx, val in world["tenants"][:n_tenants]:
            store.register(*((tree_to_torch(idx), tree_to_torch(val)) if port else (idx, val)))
    serve_tenants = n_tenants if serve_tenants is None else serve_tenants
    kw = dict(slots=slots, max_len=max_len, eos_id=eos_id, adapter_store=store,
              decode_chunk=chunk, paged=paged, draft=draft, spec_k=spec_k)
    eng = (ServeEngine(world["tm"], world["tp"], device="cpu", **kw) if port
           else JEngine(world["jm"], world["jp"], **kw))
    requests = requests or [([1, 5 + i, 9, 2], n) for i, n in enumerate((3, 7, 12, 5, 9))]
    for i, (prompt, max_new) in enumerate(requests):
        eng.submit(prompt, max_new=max_new,
                   adapter_id=(1 + i % n_tenants) if serve_tenants else 0)
    outs = [r.out for r in eng.run_to_completion()]
    return outs, (eng.spec_drafted, eng.spec_accepted, eng.spec_emitted), eng


def check_greedy_parity(world, draft: str, paged: bool, n_tenants: int) -> None:
    """Greedy tokens and drafted / accepted / emitted counts of the port
    equal the reference engine's under ``draft``, and the port's own
    ``draft="off"`` tokens; only the path's plain kernels ran. Base only
    means requests on adapter 0; the merged drafter still needs the two
    tenants registered (it is their mean). Shared by the drafters' files."""
    kw = dict(draft=draft, n_tenants=n_tenants or (2 if draft == "merged" else 0),
              serve_tenants=bool(n_tenants), paged=paged)
    want, want_counts, _ = run(world, False, **kw)
    reset_counters()
    got, counts, eng = run(world, True, **kw)
    assert got == want
    assert [len(o) for o in got] == [3, 7, 12, 5, 9]  # max_new lands mid-round
    assert counts == want_counts and counts[0] > 0
    assert eng.transfers == eng.steps and eng.kv.drained()
    assert len(eng.step_times["spec"]) > 0 and not eng.step_times["decode"]
    # verify chunks: the paged prefill kernel's plain version (the dense
    # cache's chunk attention is plain torch in both packages); a model
    # drafter's steps: the dense decode attention on its scratch cache
    assert (COUNTERS["paged_prefill_attention"].plain > 0) == paged
    assert (COUNTERS["decode_attention"].plain > 0) == (draft != "ngram")
    assert COUNTERS["paged_decode_attention"].plain == 0
    assert (COUNTERS["sparse_delta_batched"].plain > 0) == bool(kw["n_tenants"])
    assert (COUNTERS["fused_linear_q"].plain > 0) == (draft in ("int8", "nf4"))
    off, _, _ = run(world, True, **dict(kw, draft="off"))
    assert got == off


@pytest.mark.parametrize("n_tenants", [0, 2], ids=["base", "two_tenants"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_int8_drafter_greedy_tokens_and_acceptance_match_reference(world, paged, n_tenants):
    check_greedy_parity(world, "int8", paged, n_tenants)


def test_one_transfer_a_megastep(world, monkeypatch):
    """The (positions, survivors, candidates, emit mask, accepted counts,
    live masks) bundle of every round and slot comes back in one fetch."""
    _, _, eng = run(world, True, draft="off", requests=[([1, 5, 9, 2], 1)])
    eng = ServeEngine(world["tm"], world["tp"], device="cpu", slots=2, max_len=64,
                      eos_id=NO_EOS, decode_chunk=2, draft="int8", spec_k=2)
    eng.submit([1, 5, 9, 2], max_new=40)
    eng.submit([1, 6, 9, 2], max_new=40)
    eng.step()  # admission and the mixed step
    calls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: (calls.append(1), real(t))[1])
    before, n0 = eng.transfers, len(eng.scheduler.active[0].out)
    for _ in range(3):
        assert eng.step()
    assert len(calls) == 3 and eng.transfers - before == 3
    n = len(eng.scheduler.active[0].out) - n0
    assert 3 * 2 <= n <= 3 * 2 * 3  # 1 .. K + 1 tokens a round


def test_exact_drafter_accepts_every_draft(world):
    """A merged drafter over one tenant is the served model: every greedy
    draft is accepted; per-request counts sum to the engine's."""
    store = AdapterStore()
    store.register(*map(tree_to_torch, world["tenants"][0]))
    eng = ServeEngine(world["tm"], world["tp"], device="cpu", slots=2, max_len=64,
                      eos_id=NO_EOS, adapter_store=store, decode_chunk=4, draft="merged",
                      spec_k=3)
    for i in range(2):
        eng.submit([1, 5 + i, 9, 2], max_new=20, adapter_id=1)
    reqs = eng.run_to_completion()
    assert eng.spec_drafted > 0 and eng.spec_accepted == eng.spec_drafted
    assert sum(r.spec_drafted for r in reqs) == eng.spec_drafted
    assert sum(r.spec_accepted for r in reqs) == eng.spec_accepted
    assert eng.spec_emitted == sum(len(r.out) - 1 for r in reqs)  # the first is mixed


def test_ngram_keeps_no_drafter_state_and_the_prefix_fast_forward(world):
    """ngram builds no drafter params or scratch and keeps the shared-prefix
    fast-forward; a model drafter re-walks the shared pages (its scratch
    shares none) and holds a dense (L, slots, max_len, KV, hd) scratch."""
    prompt = list(range(3, 40))  # two full pages of 16 to share
    cfg = world["tm"].cfg
    for draft, lead in (("off", 32), ("ngram", 32), ("int8", 0)):
        eng = ServeEngine(world["tm"], world["tp"], device="cpu", slots=2, max_len=64,
                          eos_id=NO_EOS, draft=draft, prefill_chunk=64)
        eng.submit(prompt, max_new=4)
        eng.step()  # the whole prompt in one mixed step: its pages are written
        eng.submit(prompt, max_new=4)
        eng.scheduler.admissible(eng._try_place)
        assert eng.kv.prefix_page_hits == 2
        assert eng.scheduler.active[1].prefilled == lead, draft
        assert (eng.draft_params is None) == (eng.draft_kv is None) == (draft != "int8")
        eng.run_to_completion()
        assert eng.kv.drained()
    scratch = 2 * cfg.num_layers * 2 * 64 * cfg.num_kv_heads * cfg.resolved_head_dim * 4
    assert isinstance(eng.draft_kv, DraftKVCache) and eng.draft_kv.pool_bytes() == scratch


def test_engine_validates_draft_arguments(world):
    with pytest.raises(ValueError, match="draft"):
        ServeEngine(world["tm"], world["tp"], device="cpu", draft="fp8")
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(world["tm"], world["tp"], device="cpu", draft="int8", spec_k=0)
    with pytest.raises(ValueError, match="merged"):
        ServeEngine(world["tm"], world["tp"], device="cpu", draft="merged")
    assert DRAFT_MODES == ("off", "int8", "nf4", "merged", "ngram")


@pytest.mark.parametrize("argv", [["--spec-k", "0"], ["--draft", "fp8"], ["--draft", "merged"]])
def test_launcher_rejects_bad_spec_flags(argv):
    """Dies with a readable SystemExit before any model is built."""
    with pytest.raises(SystemExit):
        launch.main(["--reduced", "--device", "cpu", *argv])


@pytest.mark.parametrize("draft", ["ngram", "nf4"])
def test_launcher_serves_with_a_drafter(draft, capsys):
    launch.main(["--reduced", "--device", "cpu", "--draft", draft, "--spec-k", "3",
                 "--max-new", "12"])
    out = capsys.readouterr().out
    spec = [ln for ln in out.splitlines() if ln.startswith(f"spec[{draft} k=3]")]
    assert spec and "drafted=" in spec[0] and "emitted=" in spec[0]
    launch.main(["--reduced", "--device", "cpu", "--max-new", "12"])
    off = capsys.readouterr().out
    toks = lambda text: [ln for ln in text.splitlines() if ln.startswith("req")]  # noqa: E731
    assert toks(out) == toks(off)


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("draft", ["ngram", "int8"])
def test_cuda_spec_megastep_never_waits_for_the_device(draft, monkeypatch):
    """On the card a speculative megastep's fetch is its only transfer:
    the drafter's steps, the verify chunk, the accept rule and the ngram
    lookup run under ``torch.cuda.set_sync_debug_mode("error")``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    model = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    params = model.init(seed=0, device="cuda")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, model.cfg.vocab_size, size=n).tolist() for n in (4, 21, 9)]

    def serve(spec):
        eng = ServeEngine(model, params, device="cuda", slots=2, max_len=64, eos_id=NO_EOS,
                          prefill_chunk=8, decode_chunk=4, draft=spec, spec_k=3)
        for p in prompts:
            eng.submit(p, max_new=10)
        return [r.out for r in eng.run_to_completion()], eng

    want, _ = serve("off")
    serve(draft)  # builds the kernels outside the guard

    def guarded(fn):
        def call(*args, **kw):
            before = torch.cuda.get_sync_debug_mode()  # nested guards restore it
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(before)
        return call

    monkeypatch.setattr(ServeEngine, "_spec_rounds", guarded(ServeEngine._spec_rounds))
    monkeypatch.setattr(model, "prefill_chunk", guarded(model.prefill_chunk))
    monkeypatch.setattr(model, "ingest_chunk", guarded(model.ingest_chunk))
    monkeypatch.setattr(Sampler, "__call__", guarded(Sampler.__call__))
    reset_counters()
    got, eng = serve(draft)
    assert got == want and eng.transfers == eng.steps and eng.kv.drained()
    assert all(c.plain == 0 for c in COUNTERS.values())
    assert COUNTERS["paged_prefill_attention"].kernel > 0
