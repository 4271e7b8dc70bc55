"""The selection strategies and the core helpers of the port against
``repro.core`` on the CPU.

* ``magnitude``, ``reverse`` and ``gradient``: indices and order equal to
  ``repro.core.selection.topk_indices`` on the same numpy inputs (normal
  values, small integers — ties everywhere — and an NF4-dequantized matrix,
  16 codes a block), for a matrix and for (L, E, d_in, d_out) stacks;
* ``random``: by distribution only (JAX's PRNG cannot be reproduced):
  distinct rows a column, a seeded rerun equal, and a chi-square test of
  the row counts over many columns;
* the plain top-k's smallest-first mode against ``lax.top_k(-|w|)``;
* ``k_for_budget``, ``adaptable_shapes``, ``init_adapters`` under each
  strategy (one launch a stack), the packed base's refusal of ``gradient``;
* ``delta_matmul``, ``scatter_to_dense``, ``trainable_count``,
  ``adapter_bytes`` and ``map_deltas`` against ``repro.core``.

The smallest-first mode of the CUDA kernel runs on the card only: the
``gpu`` test holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core import adapt as jadapt
from repro.core import delta as jdelta
from repro.core import selection as jsel
from repro.models import get_model as j_get_model
from repro.quant import dequantize as j_dequantize
from repro.quant import quantize as j_quantize
from repro_torch.convert import tree_to_torch
from repro_torch.core import adapt, delta, selection
from repro_torch.kernels import COUNTERS, ref, reset_counters
from repro_torch.kernels import topk_select as ts
from repro_torch.quant import quantize
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def pair(w: np.ndarray, dtype="float32"):
    """(jax array, torch tensor) holding the same values in ``dtype``."""
    j = jnp.asarray(w, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if dtype == "bfloat16" else t


def values(rng, shape, kind):
    if kind == "normal":
        return rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    # an NF4-dequantized matrix: 16 codes a 64-row block, exact ties
    w = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    return np.array(j_dequantize(j_quantize(w, "nf4", 64)), np.float32)


SHAPES = [((100, 7), 1), ((128, 130), 7), ((64, 9), 64), ((2, 3, 64, 40), 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "ties", "nf4"])
@pytest.mark.parametrize("shape,k", SHAPES)
@pytest.mark.parametrize("strategy", ["magnitude", "reverse"])
def test_weight_strategies_match_reference_exactly(strategy, shape, k, kind, dtype):
    rng = np.random.default_rng(sum(shape) + k)
    jw, tw = pair(values(rng, shape, kind), dtype)
    want = np.asarray(jsel.topk_indices(jw, k, strategy=strategy))
    reset_counters()
    got = selection.topk_indices(tw, k, strategy=strategy)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert COUNTERS["topk_select"].plain == 1  # one call for the whole stack


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("shape,k", SHAPES)
def test_gradient_strategy_matches_reference_exactly(shape, k, kind, gdtype):
    """Scores |grad| in float32; a signed grad of either dtype goes in as it
    is (the selection takes |.| itself)."""
    rng = np.random.default_rng(7 * sum(shape) + k)
    w = rng.standard_normal(shape).astype(np.float32)
    jg, tg = pair(values(rng, shape, kind), gdtype)
    want = np.asarray(jsel.topk_indices(jnp.asarray(w), k, strategy="gradient", grad=jg))
    got = selection.topk_indices(torch.from_numpy(w), k, strategy="gradient", grad=tg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_strategy_errors_are_the_references():
    w = torch.randn(8, 4)
    for kw, msg in (({"strategy": "nope"}, "unknown strategy"),
                    ({"strategy": "gradient"}, "requires grad"),
                    ({"strategy": "gradient", "grad": torch.randn(4, 8)}, "grad shape"),
                    ({"strategy": "random"}, "requires rng")):
        with pytest.raises(ValueError, match=msg):
            selection.topk_indices(w, 2, **kw)
        with pytest.raises(ValueError, match=msg):
            jsel.topk_indices(jnp.asarray(w.numpy()), 2,
                              **{k: jnp.asarray(v.numpy()) if k == "grad" else v
                                 for k, v in kw.items()})
    with pytest.raises(ValueError, match="out of range"):
        selection.topk_indices(w, 9, strategy="random", rng=torch.Generator())
    assert selection.STRATEGIES == jsel.STRATEGIES


def test_random_strategy_by_distribution():
    """k distinct rows a column; the same seed gives the same indices;
    over 4000 columns of 16 rows (k = 4) each row is chosen about k/16 of
    the time: a chi-square test of the 16 row counts (15 degrees of
    freedom, 37.7 is the 0.1 % critical value) — the reference's draws
    are held to the same test."""
    d_in, d_out, k = 16, 4000, 4
    w = torch.randn(d_in, d_out)
    a = selection.topk_indices(w, k, strategy="random", rng=torch.Generator().manual_seed(5))
    b = selection.topk_indices(w, k, strategy="random", rng=torch.Generator().manual_seed(5))
    c = selection.topk_indices(w, k, strategy="random", rng=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    j = np.asarray(jsel.topk_indices(jnp.asarray(w.numpy()), k, strategy="random",
                                     rng=jax.random.PRNGKey(5)))
    expect = d_out * k / d_in
    for idx in (a.numpy(), j):
        assert idx.shape == (k, d_out)
        assert all(len(set(idx[:, o])) == k for o in range(d_out))
        counts = np.bincount(idx.reshape(-1), minlength=d_in)
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        assert chi2 < 37.7, chi2


@pytest.mark.parametrize("shape,k", [((100, 7), 3), ((64, 130), 64), ((3, 48, 40), 5)])
@pytest.mark.parametrize("kind", ["normal", "ties", "nf4"])
def test_plain_smallest_first_equals_lax_top_k_of_minus_abs(shape, k, kind):
    rng = np.random.default_rng(k + len(shape))
    w = values(rng, shape, kind)
    want = np.swapaxes(np.asarray(jax.lax.top_k(-jnp.abs(jnp.swapaxes(jnp.asarray(w), -1, -2)),
                                                k)[1]), -1, -2)
    got = ref.topk_select_ref(torch.from_numpy(w), k, largest=False)
    np.testing.assert_array_equal(got.numpy(), want)
    reset_counters()
    assert torch.equal(ts.topk_select(torch.from_numpy(w).reshape(-1, *shape[-2:]), k, False),
                       got.reshape(-1, k, shape[-1]))
    assert COUNTERS["topk_select"].plain == 1


@pytest.fixture(scope="module")
def world():
    out = {}
    for arch in ("qwen2-1.5b", "olmoe-1b-7b"):
        cfg = reduced(get_config(arch)).replace(dtype="float32")
        jp = j_get_model(cfg).init(jax.random.PRNGKey(0))
        out[arch] = (jp, tree_to_torch(np_tree(jp)))
    return out


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_budget_and_adaptable_shapes_match_reference(world, arch):
    jp, tp = world[arch]
    want = jadapt.adaptable_shapes(jp)
    got = adapt.adaptable_shapes(tp)
    assert got == want
    total = sum(x.numel() for _, x in flatten(tp) if x is not None)
    for frac in (1e-4, 1e-3, 0.01, 0.05, 0.5, 1.0):
        assert selection.k_for_budget(total, got, frac) == jsel.k_for_budget(total, want, frac)
    with pytest.raises(ValueError, match="no adaptable"):
        selection.k_for_budget(10, {"w": (0, 4, 0)}, 0.1)


@pytest.mark.parametrize("strategy", ["magnitude", "reverse", "gradient"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_init_adapters_under_each_strategy_matches_reference(world, arch, strategy):
    """Whole trees (MoE expert stacks and the untied head included), one
    selection a stack; ``gradient`` from a |dL/dW|-shaped tree."""
    jp, tp = world[arch]
    rng = np.random.default_rng(3)
    jgrads = jgrads_t = None
    if strategy == "gradient":
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
        jgrads, jgrads_t = g, tree_to_torch(g)
    jidx, _ = jadapt.init_adapters(jp, 2, strategy=strategy, grads=jgrads)
    reset_counters()
    idx, val = adapt.init_adapters(tp, 2, strategy=strategy, grads=jgrads_t)
    n_stacks = len(adapt.adaptable_shapes(tp))
    assert COUNTERS["topk_select"].plain == n_stacks
    want = dict(flatten(np_tree(jidx)))
    for p, i in flatten(idx):
        assert (i is None) == (want[p] is None), p
        if i is not None:
            np.testing.assert_array_equal(i.numpy(), want[p], err_msg=str(p))


def test_random_init_adapters_draws_leaf_by_leaf_from_one_generator(world):
    jp, tp = world["qwen2-1.5b"]
    a, _ = adapt.init_adapters(tp, 3, strategy="random", rng=torch.Generator().manual_seed(1))
    b, _ = adapt.init_adapters(tp, 3, strategy="random", rng=torch.Generator().manual_seed(1))
    j, _ = jadapt.init_adapters(jp, 3, strategy="random", rng=jax.random.PRNGKey(1))
    want = dict(flatten(np_tree(j)))
    for (p, x), (_, y) in zip(flatten(a), flatten(b)):
        assert (x is None) == (want[p] is None), p
        if x is not None:
            assert torch.equal(x, y) and x.shape == want[p].shape
            s = torch.sort(x.long(), dim=-2).values  # k distinct rows a column
            assert bool((s[..., 1:, :] != s[..., :-1, :]).all())


def test_packed_base_selection_by_strategy():
    """A packed stack selects layer by layer: ``reverse`` on the dequantized
    layers (the reference's result), ``random`` without dequantizing, and
    ``gradient`` refused (a frozen packed base has no dense |dL/dW|)."""
    from repro.quant import quantize as jq

    w = np.random.default_rng(2).standard_normal((3, 64, 24)).astype(np.float32)
    qt = quantize(torch.from_numpy(w), "nf4", 16)
    jw = j_dequantize(jq(jnp.asarray(w), "nf4", 16))
    params = {"blocks": {"wq": {"w": qt}}}
    idx, _ = adapt.init_adapters(params, 4, strategy="reverse")
    np.testing.assert_array_equal(idx["blocks"]["wq"]["w"].numpy(),
                                  np.asarray(jsel.topk_indices(jw, 4, strategy="reverse")))
    reset_counters()
    idx, _ = adapt.init_adapters(params, 4, strategy="random", rng=torch.Generator().manual_seed(0))
    assert idx["blocks"]["wq"]["w"].shape == (3, 4, 24) and COUNTERS["topk_select"].plain == 3
    with pytest.raises(ValueError, match="packed"):
        adapt.init_adapters(params, 4, strategy="gradient",
                            grads={"blocks": {"wq": {"w": torch.randn(3, 64, 24)}}})


# ---------------------------------------------------------------- helpers


def test_delta_helpers_match_reference():
    rng = np.random.default_rng(11)
    d_in, d_out, k = 20, 6, 3
    idx = np.stack([rng.permutation(d_in)[:k] for _ in range(d_out)], axis=1).astype(np.int32)
    val = rng.standard_normal((k, d_out)).astype(np.float32)
    x = rng.standard_normal((2, 5, d_in)).astype(np.float32)
    jd = jdelta.Delta(jnp.asarray(idx), jnp.asarray(val))
    td = delta.Delta(torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_allclose(delta.delta_matmul(torch.from_numpy(x), td).numpy(),
                               np.asarray(jdelta.delta_matmul(jnp.asarray(x), jd)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(delta.scatter_to_dense(td, d_in).numpy(),
                                  np.asarray(jdelta.scatter_to_dense(jd, d_in)))
    bf = delta.scatter_to_dense(td, d_in, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.float().numpy(), np.asarray(
        jdelta.scatter_to_dense(jd, d_in, dtype=jnp.bfloat16), np.float32))
    stack = delta.Delta(torch.from_numpy(np.stack([idx, idx[::-1]])),
                        torch.from_numpy(np.stack([val, 2 * val])))
    jstack = jdelta.Delta(jnp.asarray(stack.idx.numpy()), jnp.asarray(stack.val.numpy()))
    np.testing.assert_array_equal(delta.scatter_to_dense(stack, d_in).numpy(),
                                  np.asarray(jdelta.scatter_to_dense(jstack, d_in)))
    with pytest.raises(ValueError, match="rank-2"):
        delta.delta_matmul(torch.from_numpy(x), stack)
    assert delta.trainable_count(td) == jdelta.trainable_count(jd) == k * d_out
    for vdt, jvdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        t = delta.Delta(td.idx, td.val.to(vdt))
        assert delta.adapter_bytes(t) == jdelta.adapter_bytes(
            jdelta.Delta(jd.idx, jd.val.astype(jvdt)))


def test_map_deltas_matches_reference(world):
    jp, tp = world["olmoe-1b-7b"]
    jidx, jval = jadapt.init_adapters(jp, 2)
    idx, val = adapt.init_adapters(tp, 2)

    def jfn(name, d):
        return jdelta.Delta(d.idx[..., ::-1, :], d.val + len(name))

    def tfn(name, d):
        return delta.Delta(torch.flip(d.idx, (-2,)), d.val + len(name))

    ji, jv = jadapt.map_deltas(jfn, jidx, jval)
    ti, tv = adapt.map_deltas(tfn, idx, val)
    for tree, jtree in ((ti, ji), (tv, jv)):
        want = dict(flatten(np_tree(jtree)))
        got = dict(flatten(tree))
        assert got.keys() == want.keys()
        for p, x in got.items():
            assert (x is None) == (want[p] is None), p
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), want[p], err_msg=str(p))
    assert map_leaves(lambda x: x, ti).keys() == idx.keys()


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_smallest_first_matches_plain_version(cuda, dtype):
    """Ragged shapes, k 1, 2, 5, 9 and 17 (the k > 8 passes), zeros at row 0
    (the largest key of the mode), tie-heavy and NF4-dequantized stacks:
    indices and order exactly; magnitude selection unchanged beside it."""
    g = torch.Generator().manual_seed(5)
    n = 0
    reset_counters()
    for b, d_in, d_out in ((1, 100, 1), (3, 1536, 127), (2, 96, 300)):
        for kind in ("normal", "ties", "zeros", "nf4"):
            w = torch.randn(b, d_in, d_out, generator=g)
            if kind == "ties":
                w = torch.randint(-3, 4, (b, d_in, d_out), generator=g).float()
            elif kind == "zeros":
                w[:, 0] = 0.0
            elif kind == "nf4":
                from repro_torch.quant import dequantize
                w = dequantize(quantize(w, "nf4", 64)).float()
            w = w.to(dtype).to(cuda)
            for k in (1, 2, 5, 9, 17):
                for largest in (False, True):
                    got = ts.topk_select(w, k, largest).cpu()
                    assert torch.equal(got, ts.topk_select_plain(w, k, largest).cpu()), \
                        (b, d_in, d_out, kind, k, largest)
                    n += 1
    torch.cuda.synchronize()
    assert COUNTERS["topk_select"].kernel == n
