"""The parts of speculative decoding in the port, module by module, against
the JAX reference on the CPU (the engines' greedy parity:
``test_torch_spec*.py``).

``Sampler.probs`` equals the reference's distribution; ``verify_chunk``
gives the reference's (B, C, V) logits and pool rows on the paged pool and
the dense cache, base and tenants; ``ingest_chunk`` writes what
``prefill_chunk`` writes; ``build_draft_params`` shares a packed tree of
the same scheme, re-packs another, merges the tenants' mean as the
reference does (1e-6) and refuses a packed drafter on MoE. The sampled
rounds of the port's verify (a model drafter and the one-hot ngram
drafter, top-k 8) reproduce the target distribution within total
variation 0.08 over 1200 draws, where the drafter's own distribution sits
far from it. Reduced olmoe serves greedy tokens equal to the
reference's under the ngram and merged drafters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.delta import BatchedDelta as JBatchedDelta
from repro.models import get_model as j_get_model
from repro.models import transformer as jtr
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro.serve import build_draft_params as j_build_draft_params
from repro.serve.sampler import Sampler as JSampler
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.core.delta import BatchedDelta
from repro_torch.models import get_model
from repro_torch.peft import quantize_base
from repro_torch.quant import QuantizedTensor, any_quantized
from repro_torch.serve import AdapterStore, ServeEngine, build_draft_params
from repro_torch.serve.sampler import Sampler
from repro_torch.tree import flatten

torch.set_num_threads(2)
NO_EOS = 1 << 20
NONE = lambda x: x is None  # noqa: E731
TOL = 1e-4


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def make_world(arch: str, seed: int, scale: float = 0.05):
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = get_model(t_reduced(t_get_config(arch)).replace(dtype="float32"))
    rng = np.random.default_rng(5)
    tenants = []
    for _ in range(2):
        idx, val = j_init_adapters(jp, 2)
        val = jax.tree.map(lambda v: None if v is None else
                           (scale * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "tenants": tenants}


@pytest.fixture(scope="module")
def world():
    return make_world("qwen2-1.5b", 0)


def stores(tenants):
    js, ts = JStore(), AdapterStore()
    for idx, val in tenants:
        js.register(idx, val)
        ts.register(tree_to_torch(idx), tree_to_torch(val))
    return js, ts


# ---------------------------------------------------------------- sampler


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.8), (7, 0.6)])
def test_probs_match_reference(top_k, top_p):
    rng = np.random.default_rng(3 + top_k)
    logits = rng.normal(size=(4, 128)).astype(np.float32) * 3
    temps = np.array([0.0, 0.7, 1.3, 1.0], np.float32)
    want = np.asarray(JSampler(100, top_k=top_k, top_p=top_p).probs(
        jnp.asarray(logits), jnp.asarray(temps)))
    got = Sampler(100, top_k=top_k, top_p=top_p).probs(torch.from_numpy(logits),
                                                       torch.from_numpy(temps)).numpy()
    assert got.shape == (4, 100)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(got[0], np.eye(100, dtype=np.float32)[logits[0, :100].argmax()])


# ------------------------------------------------------------ verify chunk


def adapter_trees(world, aid, n_tenants):
    """The same tenant stacks as the reference's BatchedDelta tree and the
    port's; None for the plain base."""
    if not n_tenants:
        return None, None
    js, ts = stores(world["tenants"][:n_tenants])
    jidx, jval = js.stacked()
    aid_l = jnp.broadcast_to(jnp.asarray(aid)[None], (world["cfg"].num_layers, len(aid)))
    jad = {"blocks": jax.tree.map(lambda i, v: None if i is None else JBatchedDelta(i, v, aid_l),
                                  jidx["blocks"], jval["blocks"], is_leaf=NONE)}
    tidx, tval = ts.stacked("cpu")
    tad = {"blocks": {n: BatchedDelta(leaf["w"], tval["blocks"][n]["w"], torch.from_numpy(aid))
                      for n, leaf in tidx["blocks"].items()
                      if isinstance(leaf, dict) and leaf["w"] is not None}}
    return jad, tad


@pytest.mark.parametrize("n_tenants", [0, 2], ids=["base", "two_tenants"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_verify_chunk_matches_reference(world, paged, n_tenants):
    """A prefill chunk, then a verify chunk of 5 columns from each slot's
    frontier (one slot's q_len cut to 3 at the cache's end, one idle):
    logits at every column a slot owns, and every cache row, agree."""
    cfg, jp, model, tp = world["cfg"], world["jp"], world["tm"], world["tp"]
    rng = np.random.default_rng(11 + n_tenants)
    aid = np.array([1, 2, 0], np.int32) if n_tenants else np.zeros(3, np.int32)
    jad, tad = adapter_trees(world, aid, n_tenants)
    max_len, nb, page = 16, 12, 4
    if paged:
        table = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [nb] * 4], np.int32)
        extra = {"block_table": table, "write_table": table}
        jcache = jtr.init_paged_cache(cfg, nb, page)
        tcache = model.init_paged_cache(nb, page, "cpu")
    else:
        extra = {}
        jcache = jtr.init_cache(cfg, 3, max_len)
        tcache = model.init_cache(3, max_len, "cpu")
    chunks = [  # (q_offset, q_len, C): the prefill, then the verify
        ([0, 0, 0], [9, 13, 0], 13),
        ([9, 13, 0], [5, 3, 0], 5),
    ]
    for step, (q_off, q_len, c) in enumerate(chunks):
        arrs = {"tokens": rng.integers(0, cfg.vocab_size, size=(3, c)).astype(np.int32),
                "q_offset": np.array(q_off, np.int32), "q_len": np.array(q_len, np.int32),
                "last_idx": np.maximum(np.array(q_len, np.int32) - 1, 0), **extra}
        jb = {k: jnp.asarray(v) for k, v in arrs.items()}
        tb = {k: torch.from_numpy(v) for k, v in arrs.items()}
        if step == 0:
            _, jcache = jtr.prefill_chunk(cfg, jp, jad, jcache, jb)
            model.prefill_chunk(tp, tad, tcache, tb)
            continue
        want, jcache = jtr.verify_chunk(cfg, jp, jad, jcache, jb)
        got = model.verify_chunk(tp, tad, tcache, tb)
        assert got.shape == (3, c, cfg.padded_vocab)
        for s, n in enumerate(q_len):
            np.testing.assert_allclose(got[s, :n].numpy(), np.asarray(want)[s, :n],
                                       atol=TOL, rtol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key][:, :-1].numpy(), np.asarray(jcache[key]),
                                   atol=TOL, rtol=TOL)


def test_ingest_chunk_writes_what_prefill_chunk_writes(world):
    """The drafter's head-free chunk step leaves the same cache as the
    logits-gathering one (the last layer stops after its k/v write)."""
    cfg, model, tp = world["cfg"], world["tm"], world["tp"]
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)),
             "q_offset": torch.tensor([0, 3], dtype=torch.int32),
             "q_len": torch.tensor([7, 4], dtype=torch.int32),
             "last_idx": torch.tensor([6, 3], dtype=torch.int32)}
    a, b = model.init_cache(2, 16, "cpu"), model.init_cache(2, 16, "cpu")
    model.prefill_chunk(tp, None, a, batch)
    assert model.ingest_chunk(tp, None, b, batch) is None
    for key in ("k", "v"):
        torch.testing.assert_close(b[key][:, :2], a[key][:, :2], rtol=0, atol=0)
        assert float(b[key][:, :2].abs().sum()) > 0


# ------------------------------------------------------------ drafters


def leaves_close(got, want, atol):
    gflat, wflat = dict(flatten(got)), dict(flatten(np_tree(want)))
    assert set(gflat) == set(wflat)
    for path, w in wflat.items():
        g = gflat[path]
        assert (g is None) == (w is None), path
        if w is not None:
            np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0, err_msg=str(path))


def test_merged_drafter_matches_reference(world):
    """The base plus the mean of the tenants' deltas, on a dense and on a
    packed base (dequantized first)."""
    js, ts = stores(world["tenants"])
    leaves_close(build_draft_params(world["tp"], "merged", store=ts),
                 j_build_draft_params(world["jp"], "merged", store=js), 1e-6)
    tq = quantize_base(world["tp"], "int8", block=32)
    got = build_draft_params(tq, "merged", store=ts)
    assert not any_quantized(got)
    from repro.peft import quantize_base as j_quantize_base
    want = j_build_draft_params(j_quantize_base(world["jp"], "int8", block=32), "merged",
                                store=js)
    leaves_close(got, want, 1e-6)


def test_packed_drafters_share_or_repack_the_base(world):
    tp = world["tp"]
    q8 = quantize_base(tp, "int8", block=64)
    assert build_draft_params(q8, "int8") is q8  # self-draft: the served tree
    nf4 = build_draft_params(q8, "nf4")  # another scheme: dequantized, then packed
    assert nf4["blocks"]["wq"]["w"].qdtype == "nf4"
    d8 = build_draft_params(tp, "int8")
    assert d8 is not tp and isinstance(d8["blocks"]["wq"]["w"], QuantizedTensor)
    assert build_draft_params(tp, "off") is None and build_draft_params(tp, "ngram") is None
    with pytest.raises(ValueError, match="merged"):
        build_draft_params(tp, "merged", store=None)
    with pytest.raises(ValueError, match="merged"):
        build_draft_params(tp, "merged", store=AdapterStore())
    with pytest.raises(ValueError, match="draft mode"):
        build_draft_params(tp, "fp8")


# ------------------------------------------------------ sampled rounds


DRAWS, SLOTS, TV_BOUND = 1200, 200, 0.08


def spec_first_tokens(world, draft, store, temp):
    """One greedy prompt prefilled in slot 0 (on the base), its cache rows
    (and the drafter's) copied to all ``SLOTS`` slots; then the port's
    verify rounds run at temperature ``temp`` (top-k 8) from that one
    state, six megasteps of one round over every slot. Returns the
    frequencies of the first token each round emitted (1200 draws), the
    target distribution p at that state and the drafter's q for its first
    proposal (a model drafter's distribution; the ngram drafter's one-hot,
    its history set so that it proposes the target's most likely token)."""
    eng = ServeEngine(world["tm"], world["tp"], device="cpu", slots=SLOTS, max_len=32,
                      eos_id=NO_EOS, top_k=8, decode_chunk=1, draft=draft, spec_k=3,
                      adapter_store=store, paged=False)
    eng.submit([1, 5, 9, 2], max_new=8)
    eng.step()  # the mixed step: the prompt and a greedy first token
    caches = [eng.kv.data] + ([eng.draft_kv.data] if eng.draft_kv is not None else [])
    for cache in caches:
        for t in cache.values():
            t[:, 1:SLOTS] = t[:, :1]
    req = eng.scheduler.active[0]
    tok = torch.full((SLOTS,), req.out[-1], dtype=torch.int32)
    pos = torch.full((SLOTS,), int(eng.kv.pos[0]), dtype=torch.int32)
    temps = torch.full((SLOTS,), temp)
    adapters = eng._adapters(np.zeros(SLOTS, np.int32))

    def dist(params, cache):
        logits = world["tm"].decode_step(params, None, {k: v.clone() for k, v in cache.items()},
                                         {"token": tok, "pos": pos})
        return eng.sampler.probs(logits, temps)[0].numpy()

    p = dist(eng.params, eng.kv.data)
    hist = None
    if draft == "ngram":
        # the current token at 0 followed by p's mode: the lookup proposes it
        q = np.eye(p.shape[0])[p.argmax()]
        hist = torch.zeros((SLOTS, eng.max_len + 1), dtype=torch.int32)
        hist[:, :2] = torch.tensor([req.out[-1], int(p.argmax())], dtype=torch.int32)
    else:
        q = dist(eng.draft_params, eng.draft_kv.data)
    active, remaining = torch.ones(SLOTS, dtype=torch.bool), torch.full((SLOTS,), 7).int()
    firsts, c = [], eng.spec_k + 1
    for _ in range(DRAWS // SLOTS):
        bundle = eng._spec_rounds(adapters, None, tok, pos, active, remaining, temps,
                                  None if hist is None else hist.clone()).numpy()
        toks = bundle[2 * SLOTS: 2 * SLOTS + SLOTS * c].reshape(SLOTS, c)
        emits = bundle[2 * SLOTS + SLOTS * c: 2 * SLOTS + 2 * SLOTS * c].reshape(SLOTS, c)
        assert emits[:, 0].all()  # a live slot emits at least one token a round
        firsts.extend(toks[:, 0].tolist())
    return np.bincount(firsts, minlength=p.shape[0]) / len(firsts), p, q


def test_model_drafter_rounds_reproduce_the_target_distribution(world):
    """A merged drafter from two tenants with large deltas (0.2) serves
    base requests at temperature 1: q overlaps the target p but sits far
    from it, yet the first token a round emits is distributed as p (accept
    while u·q(d) < p(d), the residual max(0, p - q) at the first rejection,
    the bonus row at a full accept). Accepting on u < p(d) alone, for one,
    would move it ≈ 0.5 away."""
    _, store = stores(make_world("qwen2-1.5b", 0, scale=0.2)["tenants"])
    freq, p, q = spec_first_tokens(world, "merged", store, 1.0)
    assert freq[p == 0].sum() == 0.0  # never outside the top-k filter
    assert 0.5 * np.abs(q - p).sum() > 0.2 and (q * p).sum() > 0.05  # far, but overlapping
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv < TV_BOUND, (tv, freq[p > 0], p[p > 0])


def test_ngram_rounds_reproduce_the_target_distribution(world):
    """The deterministic drafter (q one-hot at p's mode, temperature 0.2):
    accept when u < p(d), the residual p with the d column zeroed; the
    emitted first token is still distributed as p (a residual that kept
    the d column would move it by p(d)(1 - p(d)) ≈ 0.16)."""
    freq, p, q = spec_first_tokens(world, "ngram", None, 0.2)
    assert freq[p == 0].sum() == 0.0
    tv = 0.5 * np.abs(freq - p).sum()
    assert tv < TV_BOUND, (tv, freq[p > 0], p[p > 0])
    assert p[q.argmax()] * (1 - p[q.argmax()]) > 1.5 * TV_BOUND


# ------------------------------------------------------------------ olmoe


@pytest.fixture(scope="module")
def moe_world():
    return make_world("olmoe-1b-7b", 3)


@pytest.mark.parametrize("draft", ["ngram", "merged"])
def test_olmoe_greedy_tokens_match_reference(moe_world, draft):
    """Reduced olmoe (expert stacks, untied head with tenant deltas) on the
    paged pool: greedy tokens and acceptance equal the reference's; the
    merged drafter folds the tenants' (L, E, k, F) expert deltas."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(3, moe_world["cfg"].vocab_size, size=n).tolist() for n in (4, 21, 9)]
    outs = []
    for port in (False, True):
        js, ts = stores(moe_world["tenants"])
        kw = dict(slots=2, max_len=64, eos_id=NO_EOS, prefill_chunk=8, decode_chunk=4,
                  paged=True, draft=draft, spec_k=3, adapter_store=ts if port else js)
        eng = (ServeEngine(moe_world["tm"], moe_world["tp"], device="cpu", **kw) if port
               else JEngine(moe_world["jm"], moe_world["jp"], **kw))
        for i, p in enumerate(prompts):
            eng.submit(p, max_new=(6, 9, 5)[i], adapter_id=i % 3)
        outs.append(([r.out for r in eng.run_to_completion()],
                     (eng.spec_drafted, eng.spec_accepted, eng.spec_emitted)))
    assert outs[1] == outs[0] and outs[1][1][0] > 0
    assert eng.transfers == eng.steps and eng.kv.drained()


@pytest.mark.parametrize("draft", ["int8", "nf4"])
def test_packed_drafter_on_moe_is_refused(moe_world, draft):
    """No longer refused: the drafter packs olmoe's expert stacks, attention
    and head in its scheme (the router stays dense), and the engine builds
    on it (greedy parity in ``test_torch_moe_quant.py``)."""
    from repro_torch.quant import QuantizedTensor

    dp = build_draft_params(moe_world["tp"], draft)
    for name in ("wgate", "wup", "wdown", "wq"):
        w = dp["blocks"][name]["w"]
        assert isinstance(w, QuantizedTensor) and w.qdtype == draft
    assert isinstance(dp["head"]["w"], QuantizedTensor)
    assert not isinstance(dp["blocks"]["router"]["w"], QuantizedTensor)
    ServeEngine(moe_world["tm"], moe_world["tp"], device="cpu", draft=draft)
