"""A packed (int8 / NF4) frozen base on the families of slices 15 and 16
in the port against the JAX reference, on the CPU: qwen2-vl-2b here; the
encoder-decoder, SSM and hybrid families in
``test_torch_families_quant_{encdec,ssm,hybrid}.py``, which share the
helpers here (one family a file keeps each file near 30 s).

Reduced configs (the settings of ``test_torch_vlm.py``,
``test_torch_encdec.py``, ``test_torch_mamba.py`` and
``test_torch_zamba2.py``) in float32, the reference's params packed by
both packages with scale blocks of 32, on each base:

* ``quantize_base`` packs every adaptable matrix byte for byte as the
  reference does, and nothing else;
* selection picks the reference's indices, one matrix at a time;
* logits within 1e-4, the loss within 1e-5 and every value gradient within
  rtol 1e-4 against the reference's jnp backend (``check_loss_and_grads``),
  every adapted projection through the packed linear's plain version and
  none through the dense one; an untied head without a bypass gets a zero
  gradient;
* the packed linear's plain version against the reference's Pallas kernel
  in interpret mode (rtol 1e-5) at layer 0's packed projections, one of each
  shape the kernel tiles;
* eight greedy tokens from ``prefill`` + ``decode_step`` with an adapter
  equal to the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.adapt import init_adapters as j_init_adapters
from repro.kernels.quant_linear import fused_linear_q_pallas
from repro.peft import quantize_base as j_quantize_base
from repro.quant import QuantizedTensor as JQT
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.kernels import quant_linear as ql
from repro_torch.peft import quantize_base
from repro_torch.quant import QuantizedTensor
from repro_torch.tree import flatten
from test_torch_mamba import (
    check_loss_and_grads,
    check_selection,
    greedy,
    make_world,
    np_tree,
    pad_seq,
    tokens,
)

torch.set_num_threads(2)
BLOCK = 32
BASES = ("int8", "nf4")
IS_LEAF = lambda x: x is None or isinstance(x, JQT)  # noqa: E731
# arch -> reduced-config overrides (zamba2: 2 groups of 2, as test_torch_zamba2.py)
CFG_KW = {"qwen2-vl-2b": {}, "falcon-mamba-7b": {}, "zamba2-2.7b": dict(num_layers=4, attn_every=2),
          "seamless-m4t-large-v2": {}}
# the decode cache's sequence-axis leaves of each family, padded for the new tokens
KV_KEYS = {"qwen2-vl-2b": ("k", "v"), "falcon-mamba-7b": (),
           "zamba2-2.7b": ("shared_k", "shared_v"), "seamless-m4t-large-v2": ("self_k", "self_v")}


@functools.lru_cache(maxsize=None)
def dense_world(arch):
    return make_world(arch, **CFG_KW[arch])


def packed_world(arch, base):
    """The dense world's params packed by both packages; the reference's
    selection on its packed tree with random values."""
    w = dense_world(arch)
    jq = j_quantize_base(w["jp"], base, block=BLOCK)
    idx, val = jax.jit(lambda p: j_init_adapters(p, 2))(jq)
    r = np.random.default_rng(8)
    val = jax.tree.map(lambda v: None if v is None else
                       jnp.asarray(0.05 * r.standard_normal(v.shape), jnp.float32),
                       val, is_leaf=lambda x: x is None)
    return dict(w, arch=arch, base=base, jp=jq, idx=idx, val=val,
                tp=quantize_base(w["tp"], base, block=BLOCK))


def arch_batch(world, b=2, s=16):
    """A training batch of the world's family: tokens and targets, and the
    encoder-decoder's frames or the VLM's patches and M-RoPE positions."""
    batch = {"tokens": tokens(world, b, s), "targets": tokens(world, b, s, seed=2)}
    cfg = world["cfg"]
    if cfg.family == "encdec":
        batch["frames"] = frames(world, b)
    if cfg.family == "vlm":
        from test_torch_vlm import vlm_batch

        batch = vlm_batch(world, b=b, s_txt=s - 4, n_img=4)
    return batch


def frames(world, b, seed=5):
    return np.random.default_rng(seed).standard_normal((b, 24, world["cfg"].d_model)).astype(
        np.float32)


def check_packing(world):
    want = {"/".join(str(getattr(k, "key", k)) for k in p): x
            for p, x in jax.tree_util.tree_flatten_with_path(world["jp"], is_leaf=IS_LEAF)[0]}
    packed = {"/".join(p): x for p, x in flatten(world["tp"]) if isinstance(x, QuantizedTensor)}
    assert sorted(packed) == sorted(n for n, x in want.items() if isinstance(x, JQT))
    assert sorted(packed) == sorted("/".join(p) for p, x in flatten(np_tree(world["idx"]))
                                    if x is not None)
    for name, x in packed.items():
        w = want[name]
        assert (x.qdtype, x.block, x.shape) == (w.qdtype, w.block, tuple(w.shape)), name
        assert x.data.numpy().tobytes() == np.asarray(w.data).tobytes(), name
        assert x.scales.numpy().tobytes() == np.asarray(w.scales).tobytes(), name


def check_packed_selection(world):
    """The reference's indices; one ``topk_select`` a (d_in, d_out) matrix."""
    reset_counters()
    check_selection(world, {"/".join(p) for p, x in flatten(np_tree(world["idx"]))
                            if x is not None})
    n_mat = sum(int(np.prod(x.shape[:-2])) for _, x in flatten(world["tp"])
                if isinstance(x, QuantizedTensor))
    assert COUNTERS["topk_select"].plain == n_mat


def check_packed_grads(world):
    batch = arch_batch(world)
    n_adapted = sum(1 for _, x in flatten(np_tree(world["idx"])) if x is not None)
    grads = check_loss_and_grads(world, batch, n_adapted)
    assert COUNTERS["fused_linear"].plain == 0 and COUNTERS["fused_linear_q"].plain > 0
    if world["cfg"].family in ("ssm", "hybrid", "encdec"):
        assert not grads[("head", "w")].any()  # no head bypass, as in the reference


def check_interpret(world):
    """Layer 0's packed projections, one of each (K, N): the plain packed
    linear against the Pallas kernel in interpret mode wherever it tiles (K
    a multiple of its K tile, itself a multiple of the scale block); at
    least one does."""
    want_idx = dict(flatten(np_tree(world["idx"])))
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in p): x
               for p, x in jax.tree_util.tree_flatten_with_path(world["jp"], is_leaf=IS_LEAF)[0]}
    r = np.random.default_rng(9)
    seen, tiled = set(), 0
    for path, qt in flatten(world["tp"]):
        if not isinstance(qt, QuantizedTensor) or qt.shape[-2:] in seen:
            continue
        name, lead = "/".join(path), qt.ndim - 2
        jt, idx = jleaves[name], want_idx[path]
        for _ in range(lead):
            qt, jt, idx = qt[0], JQT(jt.data[0], jt.scales[0], jt.qdtype, jt.block,
                                     jt.dtype_name), idx[0]
        kd, nd = qt.shape
        seen.add((kd, nd))
        if kd % min(512, kd) or min(512, kd) % BLOCK or nd % min(128, nd):
            continue
        x = r.standard_normal((8, kd)).astype(np.float32)
        val = (0.05 * r.standard_normal(idx.shape)).astype(np.float32)
        want = fused_linear_q_pallas(jnp.asarray(x), jt.data, jt.scales, jnp.asarray(idx),
                                     jnp.asarray(val), None, qdtype=qt.qdtype, block=BLOCK,
                                     block_m=8, interpret=True)
        got = ql.fused_linear_q(torch.from_numpy(x), qt.data, qt.scales, torch.tensor(idx),
                                torch.from_numpy(val), None, qdtype=qt.qdtype, block=BLOCK)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(want)).max(), err_msg=name)
        tiled += 1
    assert tiled > 0


def check_packed_greedy(world):
    keys = KV_KEYS[world["arch"]]
    pad = lambda c: dict(c, **{k: pad_seq(c[k], 2) for k in keys})  # noqa: E731
    extra = {"frames": frames(world, 2, seed=6)} if world["cfg"].family == "encdec" else None
    port, ref = greedy(world, pad, extra=extra)
    np.testing.assert_array_equal(port, ref)


CHECKS = {"packing": check_packing, "selection": check_packed_selection,
          "loss_and_grads": check_packed_grads, "interpret": check_interpret,
          "greedy": check_packed_greedy}


@pytest.fixture(scope="module", params=BASES)
def world(request):
    return packed_world("qwen2-vl-2b", request.param)


@pytest.mark.parametrize("check", CHECKS)
def test_packed_base_matches_the_reference(world, check):
    CHECKS[check](world)
