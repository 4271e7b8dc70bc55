"""The port's model, core and checkpoint modules against the JAX reference.

Reduced qwen2-1.5b in fp32: the reference's random params convert leaf by
leaf into the port, and ``prefill_chunk``/``decode_step`` give the same
logits and write the same paged pools (atol/rtol 1e-4: the same f32 sums
taken in another order), plain and with two tenants. Also: the converter,
top-k selection (ties toward the lower index), merge, npz files across
packages, the import isolation of ``repro_torch`` and its CUDA default.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_config, reduced
from repro.core import delta as jdelta
from repro.core import selection as jsel
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.delta import BatchedDelta as JBatchedDelta
from repro.models import get_model as j_get_model
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.serve import AdapterStore as JStore
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import to_tensor, tree_to_numpy, tree_to_torch
from repro_torch.core import adapt as tadapt
from repro_torch.core import delta as tdelta
from repro_torch.core import selection as tsel
from repro_torch.core.delta import BatchedDelta
from repro_torch.models import get_model, layers, transformer
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.tree import flatten

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jparams = j_get_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32")
    tparams = tree_to_torch(np_tree(jparams))
    rng = np.random.default_rng(3)
    tenants = []
    for _ in range(2):
        idx, val = j_init_adapters(jparams, 2)
        val = jax.tree.map(lambda v: None if v is None else
                           (0.05 * rng.standard_normal(v.shape)).astype(np.float32),
                           val, is_leaf=NONE)
        tenants.append((np_tree(idx), val))
    return cfg, jparams, get_model(tcfg), tparams, tenants


# ------------------------------------------------------------ converter


def test_converter_keeps_layout_dtypes_and_bits():
    cfg = reduced(get_config("qwen2-1.5b"))  # bf16, the config's own dtype
    jparams = np_tree(j_get_model(cfg).init(jax.random.PRNGKey(1)))
    tparams = tree_to_torch(jparams)
    ours = get_model(t_reduced(t_get_config("qwen2-1.5b"))).init(seed=0, device="cpu")
    jflat, tflat, oflat = (dict(flatten(t)) for t in (jparams, tparams, ours))
    assert set(jflat) == set(tflat) == set(oflat)
    for path, a in jflat.items():
        t, o = tflat[path], oflat[path]
        assert t.dtype == o.dtype == torch.bfloat16
        assert tuple(t.shape) == a.shape == tuple(o.shape)
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    back = dict(flatten(tree_to_numpy(tparams)))
    for path, a in jflat.items():
        np.testing.assert_array_equal(np.asarray(a, np.float32), back[path])


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 5, 4, 16)), dtype)
    w = jnp.asarray(rng.normal(size=(16,)), dtype)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-6
    tx, tw = to_tensor(np.asarray(x)), to_tensor(np.asarray(w))
    got = layers.rms_norm(tx, tw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jlayers.rms_norm(x, w), np.float32),
                               atol=tol, rtol=tol)
    cos, sin = layers.rope_angles(torch.from_numpy(pos), layers.rope_freqs(16, 1e6))
    got = layers.apply_rope(tx, cos, sin)
    want = jlayers.apply_rope(x, jnp.asarray(pos), 1e6)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=max(tol, 1e-5), rtol=max(tol, 1e-5))


@pytest.mark.parametrize("decode", [False, True])
def test_paged_writers_drop_sentinel_writes_like_reference(decode):
    """Writes through sentinel table entries, pad columns and idle slots
    land in the trash block and leave the pool exactly as the reference's
    ``mode="drop"`` scatter does."""
    rng = np.random.default_rng(4)
    nb, page, kv, hd = 6, 4, 2, 8
    pool = rng.normal(size=(nb, page, kv, hd)).astype(np.float32)
    table = np.array([[2, 0, nb], [5, nb, nb], [nb, nb, nb]], np.int32)
    tcache = torch.from_numpy(np.concatenate([pool, np.zeros((1, page, kv, hd), np.float32)]))
    if decode:
        new = rng.normal(size=(3, 1, kv, hd)).astype(np.float32)
        pos = np.array([5, 2, 7], np.int32)
        want = jlayers.paged_cache_update(jnp.asarray(pool), jnp.asarray(new),
                                          jnp.asarray(table), jnp.asarray(pos))
        layers.paged_cache_update(tcache, torch.from_numpy(new), torch.from_numpy(table),
                                  torch.from_numpy(pos))
    else:
        new = rng.normal(size=(3, 5, kv, hd)).astype(np.float32)
        q_off, q_len = np.array([2, 1, 0], np.int32), np.array([5, 3, 0], np.int32)
        want = jlayers.paged_chunk_cache_update(
            jnp.asarray(pool), jnp.asarray(new), jnp.asarray(table), jnp.asarray(q_off),
            jnp.asarray(q_len))
        layers.paged_chunk_cache_update(tcache, torch.from_numpy(new), torch.from_numpy(table),
                                        torch.from_numpy(q_off), torch.from_numpy(q_len))
    np.testing.assert_array_equal(tcache[:nb].numpy(), np.asarray(want))


# ----------------------------------------------------- model parity (fp32)


def _adapters(setup, aid, n_tenants):
    """The same tenant stacks as the reference's BatchedDelta tree and the
    port's; ``None`` for the plain base."""
    cfg, _, _, _, tenants = setup
    if not n_tenants:
        return None, None
    js, ts = JStore(), AdapterStore()
    for idx, val in tenants[:n_tenants]:
        js.register(idx, val)
        ts.register(tree_to_torch(idx), tree_to_torch(val))
    jidx, jval = js.stacked()
    aid_l = jnp.broadcast_to(jnp.asarray(aid)[None], (cfg.num_layers, len(aid)))
    jad = {"blocks": jax.tree.map(lambda i, v: None if i is None else JBatchedDelta(i, v, aid_l),
                                  jidx["blocks"], jval["blocks"], is_leaf=NONE)}
    tidx, tval = ts.stacked("cpu")
    tad = {"blocks": {n: BatchedDelta(leaf["w"], tval["blocks"][n]["w"], torch.from_numpy(aid))
                      for n, leaf in tidx["blocks"].items()
                      if isinstance(leaf, dict) and leaf["w"] is not None}}
    return jad, tad


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n_tenants", [0, 2])
def test_prefill_chunk_and_decode_step_match_reference(setup, n_tenants):
    """Two mixed chunks (a prefill spanning both, a one-token decode chunk,
    a shared page in the write table, an idle slot) then a decode step:
    logits and every pool row agree."""
    cfg, jparams, model, tparams, _ = setup
    rng = np.random.default_rng(7 + n_tenants)
    nb, page, n_pages, c = 12, 4, 5, 6
    aid = np.array([1, 2, 0], np.int32) if n_tenants else np.zeros(3, np.int32)
    jad, tad = _adapters(setup, aid, n_tenants)
    table = np.array([[0, 1, 2, 3, 4], [0, 5, 6, 7, nb], [nb] * 5], np.int32)
    wtable = table.copy()
    wtable[1, 0] = nb  # slot 1 reads slot 0's first page, never writes it
    jcache = jtr.init_paged_cache(cfg, nb, page)
    tcache = transformer.init_paged_cache(model.cfg, nb, page, "cpu")
    steps = [  # (q_offset, q_len, last_idx)
        ([0, 0, 0], [6, 4, 0], [5, 3, 0]),
        ([6, 4, 0], [1, 6, 0], [0, 5, 0]),
    ]
    for q_off, q_len, last in steps:
        tokens = rng.integers(0, cfg.vocab_size, size=(3, c)).astype(np.int32)
        arrs = {"tokens": tokens, "q_offset": np.array(q_off, np.int32),
                "q_len": np.array(q_len, np.int32), "last_idx": np.array(last, np.int32),
                "block_table": table, "write_table": wtable}
        want, jcache = jtr.prefill_chunk(cfg, jparams, jad, jcache,
                                         {k: jnp.asarray(v) for k, v in arrs.items()})
        got = model.prefill_chunk(tparams, tad, tcache,
                                  {k: torch.from_numpy(v) for k, v in arrs.items()})
        _close(got, want)
        for key in ("k", "v"):
            _close(tcache[key][:, :nb], jcache[key])
    tok = rng.integers(0, cfg.vocab_size, size=(3,)).astype(np.int32)
    pos = np.array([7, 10, 0], np.int32)
    want, jcache = jtr.decode_step(cfg, jparams, jad, jcache, {
        "token": jnp.asarray(tok), "pos": jnp.asarray(pos), "block_table": jnp.asarray(table)})
    got = model.decode_step(tparams, tad, tcache, {
        "token": torch.from_numpy(tok), "pos": torch.from_numpy(pos),
        "block_table": torch.from_numpy(table)})
    _close(got, want)
    for key in ("k", "v"):
        _close(tcache[key][:, :nb], jcache[key])


# ------------------------------------------------------------------ core


def test_topk_selection_breaks_ties_toward_lower_index():
    rng = np.random.default_rng(0)
    w = rng.integers(-3, 4, size=(2, 16, 9)).astype(np.float32)  # many ties
    want = jsel.topk_indices(jnp.asarray(w), 5, strategy="magnitude")
    got = tsel.topk_indices(torch.from_numpy(w), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
    with pytest.raises(ValueError):
        tsel.topk_indices(torch.from_numpy(w), 17)
    with pytest.raises(ValueError):
        tsel.topk_indices(torch.from_numpy(w), 2, strategy="gradient")


def test_init_and_merge_adapters_match_reference(setup):
    _, jparams, _, tparams, tenants = setup
    jidx, _ = j_init_adapters(jparams, 2)
    tidx, tval = tadapt.init_adapters(tparams, 2)
    jflat, tflat = dict(flatten(np_tree(jidx))), dict(flatten(tidx))
    assert set(jflat) == set(tflat)
    for path, a in jflat.items():
        b = tflat[path]
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), a)
            assert tval_leaf_zero(tval, path)
    idx, val = tenants[0]
    w = tparams["blocks"]["wq"]["w"]
    d = tdelta.Delta(to_tensor(idx["blocks"]["wq"]["w"]), to_tensor(val["blocks"]["wq"]["w"]))
    want = jdelta.merge(jnp.asarray(np.asarray(w)), jdelta.Delta(
        jnp.asarray(idx["blocks"]["wq"]["w"]), jnp.asarray(val["blocks"]["wq"]["w"])))
    np.testing.assert_allclose(tdelta.merge(w, d).numpy(), np.asarray(want), atol=1e-6)
    merged = tadapt.merge_adapters(tparams, tree_to_torch(idx), tree_to_torch(val))
    np.testing.assert_allclose(merged["blocks"]["wq"]["w"].numpy(), np.asarray(want), atol=1e-6)
    assert merged["embed"]["w"] is tparams["embed"]["w"]


def tval_leaf_zero(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node.dtype == torch.float32 and not node.any()


# ----------------------------------------------------------- checkpoints


def test_npz_trees_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    bf = jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16)
    jtree = {"a": {"w": bf, "b": None}, "n": jnp.asarray(np.arange(5, dtype=np.int32))}
    jckpt.save_pytree(str(tmp_path / "j.npz"), jtree)
    got = tckpt.load_pytree(str(tmp_path / "j.npz"))
    assert got["a"]["b"] is None and got["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["a"]["w"].view(torch.int16).numpy(),
                                  np.asarray(bf).view(np.int16))
    np.testing.assert_array_equal(got["n"].numpy(), np.arange(5))
    tckpt.save_pytree(str(tmp_path / "t.npz"), got, metadata={"k": 2})
    back = jckpt.load_pytree(str(tmp_path / "t.npz"))
    assert back["a"]["b"] is None and back["a"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["a"]["w"], np.float32),
                                  np.asarray(bf, np.float32))
    assert (tmp_path / "t.npz.meta.json").exists()


# ------------------------------------------------------ isolation, device


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.peft, repro_torch.kernels.build, "
            "repro_torch.train, repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.distributed, repro_torch.quant, "
            "repro_torch.models.moe, repro_torch.obs, repro_torch.obs.metrics, "
            "repro_torch.obs.trace, repro_torch.serve.chaos, repro_torch.serve.frontend; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax_or_reference_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders


def test_entry_points_need_cuda_unless_asked_for_cpu(setup, monkeypatch):
    from repro_torch.launch import serve as launch

    _, _, model, tparams, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, tparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--reduced", "--max-new", "1"])
    eng = ServeEngine(model, tparams, device="cpu", slots=1, max_len=16)
    assert eng.device.type == "cpu" and eng.kv.data["k"].device.type == "cpu"
