"""The port's MoE FFN and its single-tenant bypass kernel against the JAX
reference, on the CPU.

Reduced olmoe-1b-7b in fp32 (2 layers, d 64, 4 experts top-2, d_ff 128,
capacity factor 1.25), the reference's layer params converted leaf by leaf
and the same numpy inputs fed to both packages:

* ``moe_ffn`` (output and aux loss) against ``repro.models.moe.moe_ffn``
  on the ``jnp`` and ``pallas_interpret`` backends, with no adapter, a
  training ``Delta`` per expert stack and a serving ``BatchedDelta``
  (atol 1e-5: the same float32 sums in another order);
* capacity drops (factor 0.25, and routing groups of 16 tokens), forced
  router ties (duplicated router columns, an all-zero router): the same
  expert choice as ``jax.lax.top_k`` (ties to the lower expert) and the
  same outputs;
* the param tree (router, expert stacks, head) converted leaf by leaf;
* ``sparse_delta_plain`` at B = 1 and B = E against ``sparse_delta_pallas``
  in interpret mode, vmapped as ``moe.py:165`` does, in fp32 and bf16;
  batched ``sparse_delta_dval_plain`` against the reference's dval kernel
  vmapped the same way; the gradient of ``ops.delta_apply`` (dx, dval) on
  a head-like matrix and on an expert stack against ``jax.vjp`` of the
  reference's ``ops.delta_apply`` under its Pallas kernels (interpret).

The CUDA kernels are held against the plain versions by the ``gpu`` test,
which skips without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.delta import BatchedDelta as JBatchedDelta
from repro.core.delta import Delta as JDelta
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sparse_delta import sparse_delta_dval_pallas, sparse_delta_pallas
from repro.models import get_model as j_get_model
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import to_tensor, tree_to_torch
from repro_torch.core.delta import BatchedDelta, Delta
from repro_torch.kernels import COUNTERS, ops, reset_counters
from repro_torch.kernels import sparse_delta as sd
from repro_torch.models import moe

torch.set_num_threads(2)
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}
EXPERT_SHAPES = {"wgate": (64, 128), "wup": (64, 128), "wdown": (128, 64)}


def both(arr, dtype=jnp.float32):
    j = jnp.asarray(arr, dtype)
    return j, to_tensor(np.asarray(j))


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def layer():
    """(reference cfg, port cfg, reference layer-0 params, the port's copy)."""
    cfg = reduced(get_config("olmoe-1b-7b")).replace(dtype="float32")
    jp = j_get_model(cfg).init(jax.random.PRNGKey(0))
    p0 = jax.tree.map(lambda x: np.asarray(x[0]), jp["blocks"])
    tcfg = t_reduced(t_get_config("olmoe-1b-7b")).replace(dtype="float32")
    return cfg, tcfg, jax.tree.map(jnp.asarray, p0), tree_to_torch(p0)


def expert_adapters(rng, kind, e=4, k=2, n=3, aid=(2, 1, 0, 1)):
    """(reference, port) adapter dicts over the three expert stacks."""
    if kind == "none":
        return None, None
    ja, ta = {}, {}
    for name, (d_in, d_out) in EXPERT_SHAPES.items():
        lead = (e,) if kind == "delta" else (n, e)
        idx = rng.integers(0, d_in, size=(*lead, k, d_out)).astype(np.int32)
        val = (0.1 * rng.normal(size=(*lead, k, d_out))).astype(np.float32)
        if kind == "delta":
            ja[name] = JDelta(jnp.asarray(idx), jnp.asarray(val))
            ta[name] = Delta(torch.from_numpy(idx), torch.from_numpy(val))
        else:
            val[0] = 0.0  # tenant 0 is the base
            a = np.asarray(aid, np.int32)
            ja[name] = JBatchedDelta(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(a))
            ta[name] = BatchedDelta(torch.from_numpy(idx), torch.from_numpy(val),
                                    torch.from_numpy(a))
    return ja, ta


def run_both(layer, x, ja, ta, backend="jnp", **cfg_kw):
    cfg, tcfg, jp, tp = layer
    cfg, tcfg = cfg.replace(**cfg_kw), tcfg.replace(**cfg_kw)
    with jops.use_backend(backend):
        jy, jaux = jmoe.moe_ffn(cfg, jp, ja, jnp.asarray(x))
    ty, taux = moe.moe_ffn(tcfg, tp, ta, torch.from_numpy(x))
    return (np.asarray(jy), float(jaux)), (ty, float(taux))


# ----------------------------------------------------------------- moe_ffn


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("kind", ["none", "delta", "batched"])
def test_moe_ffn_matches_reference(layer, backend, kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 16, 64)).astype(np.float32)
    ja, ta = expert_adapters(rng, kind)
    reset_counters()
    (jy, jaux), (ty, taux) = run_both(layer, x, ja, ta, backend)
    close(ty, jy, 1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    # one bypass call per expert linear, whatever the group and expert count
    want = {"none": (0, 0), "delta": (3, 0), "batched": (0, 3)}[kind]
    assert (COUNTERS["sparse_delta"].plain, COUNTERS["sparse_delta_batched"].plain) == want


@pytest.mark.parametrize("kind", ["none", "batched"])
def test_serving_forward_skips_the_aux_loss(layer, kind):
    """``with_aux=False`` (the serving forwards) gives the training
    forward's output bit for bit and no loss."""
    _, tcfg, _, tp = layer
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 8, 64)).astype(np.float32))
    ta = expert_adapters(rng, kind, aid=(2, 1))[1]
    y, aux = moe.moe_ffn(tcfg, tp, ta, x)
    y_serve, none = moe.moe_ffn(tcfg, tp, ta, x, with_aux=False)
    assert none is None and aux.ndim == 0
    assert torch.equal(y_serve, y)


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
@pytest.mark.parametrize("kind", ["none", "batched"])
def test_capacity_drops_match_reference(layer, capacity_factor, kind):
    """(4, 64) tokens route in 32 groups of 8: at factor 0.25 every expert
    takes 2 of a group's 16 assignments and most are dropped; at 1.25 some
    still are."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64, 64)).astype(np.float32)
    ja, ta = expert_adapters(rng, kind)
    (jy, jaux), (ty, taux) = run_both(layer, x, ja, ta, capacity_factor=capacity_factor)
    close(ty, jy, 1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)
    tcfg = layer[1].replace(capacity_factor=capacity_factor)
    g = moe.num_groups(256, 2)
    probs = torch.softmax((torch.from_numpy(x).reshape(g, -1, 64) @ layer[3]["router"]["w"]), -1)
    route, _ = moe._route_group(tcfg, probs, moe.capacity(tcfg, 256 // g))
    assert g == 32 and not bool(route.keep.all())


@pytest.mark.parametrize("router", ["duplicated_columns", "zeros"])
def test_forced_router_ties_choose_the_lower_expert(layer, router):
    cfg, tcfg, jp, tp = layer
    w = np.asarray(jp["router"]["w"]).copy()
    if router == "zeros":
        w[:] = 0.0  # every expert ties for every token
    else:
        w[:, 3] = w[:, 1]  # experts 1 and 3 tie exactly, bit for bit
        w[:, 2] = w[:, 0]
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    tp = {**tp, "router": {"w": torch.from_numpy(w)}}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", jnp.asarray(x.reshape(-1, 64)),
                                      jnp.asarray(w)).astype(jnp.float32), axis=-1)
    _, want = jax.lax.top_k(probs, cfg.experts_per_token)
    tprobs = torch.from_numpy(np.array(probs))
    _, got = moe.top_k(tprobs, tcfg.experts_per_token)
    _, top1 = moe._route_group(tcfg, tprobs[None], 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(top1[0].numpy(), np.asarray(want)[:, 0])
    assert (np.asarray(want)[:, 0] < np.asarray(want)[:, 1]).all()  # ties: lower first
    (jy, jaux), (ty, taux) = run_both((cfg, tcfg, jp, tp), x, None, None)
    close(ty, jy, 1e-5)
    np.testing.assert_allclose(taux, jaux, rtol=1e-6)


def test_dispatch_scatters_tenant_ids_like_reference(layer):
    """Each buffer row carries its token's tenant (combined with its expert
    into the (N·E) stack id); empty rows keep tenant 0."""
    cfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 16, 64)).astype(np.float32)
    ja, ta = expert_adapters(rng, "batched", aid=(2, 1, 0, 1))
    g = moe.num_groups(64, 2)
    c = moe.capacity(tcfg, 64 // g)
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(g, -1, 64), jp["router"]["w"])
    jroute = jax.vmap(lambda xg, pg: jmoe._route_group(cfg, xg, pg, c))(
        jnp.asarray(x).reshape(g, -1, 64), jax.nn.softmax(logits.astype(jnp.float32), -1))[1]
    want = np.asarray(jmoe._dispatch_adapter_ids(ja, jroute, 4, 16, g, 4, c))  # (G, E, C)
    probs = torch.softmax(torch.from_numpy(x).reshape(g, -1, 64) @ tp["router"]["w"], -1)
    route, _ = moe._route_group(tcfg, probs, c)
    got = moe._dispatch_adapter_ids(ta, route, 4, 16, 4)  # (E, G·C) combined ids
    tenant = (got // 4).reshape(4, g, c).permute(1, 0, 2).numpy()
    expert = (got % 4).reshape(4, g, c).permute(1, 0, 2).numpy()
    np.testing.assert_array_equal(tenant, want)
    np.testing.assert_array_equal(expert, np.broadcast_to(np.arange(4)[None, :, None],
                                                          want.shape))
    assert got.dtype == torch.int32


def test_group_count_and_capacity_follow_reference(layer):
    cfg, tcfg = layer[0], layer[1]
    for t in (1, 2, 3, 8, 48, 64, 256, 2048, 4096):
        g = moe.num_groups(t, cfg.experts_per_token)
        gg = 32
        while t % gg or (t // gg) < cfg.experts_per_token:
            gg //= 2
            if gg <= 1:
                gg = 1
                break
        assert g == gg, t
        for cf in (0.25, 1.0, 1.25):
            assert moe.capacity(tcfg.replace(capacity_factor=cf), t // g) == jmoe.capacity(
                cfg.replace(capacity_factor=cf), t // g)
    full = t_get_config("olmoe-1b-7b")
    assert (moe.num_groups(2048, 8), moe.capacity(full, 64)) == (32, 10)  # training
    assert (moe.num_groups(8, 8), moe.capacity(full, 8)) == (1, 8)  # decode: no drop


def test_moe_param_tree_converts_leaf_by_leaf():
    """The reference's olmoe tree (router, (L, E, ·, ·) expert stacks, untied
    head; bf16, the config's own dtype) crosses leaf by leaf with its bits,
    in the layout and dtypes of the port's own ``init_params``, and back."""
    from repro_torch.convert import tree_to_numpy
    from repro_torch.models import get_model
    from repro_torch.tree import flatten

    cfg = reduced(get_config("olmoe-1b-7b"))
    jparams = jax.tree.map(np.asarray, j_get_model(cfg).init(jax.random.PRNGKey(1)))
    tparams = tree_to_torch(jparams)
    ours = get_model(t_reduced(t_get_config("olmoe-1b-7b"))).init(seed=0, device="cpu")
    jflat, tflat, oflat = (dict(flatten(t)) for t in (jparams, tparams, ours))
    assert set(jflat) == set(tflat) == set(oflat)
    assert tflat[("blocks", "wdown", "w")].shape == (2, 4, 128, 64)
    assert tflat[("blocks", "router", "w")].shape == (2, 64, 4)
    for path, a in jflat.items():
        t, o = tflat[path], oflat[path]
        assert t.dtype == o.dtype == torch.bfloat16, path
        assert tuple(t.shape) == a.shape == tuple(o.shape), path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    back = dict(flatten(tree_to_numpy(tparams)))
    for path, a in jflat.items():
        np.testing.assert_array_equal(np.asarray(a, np.float32), back[path])


# ------------------------------------------------- single-tenant bypass


def batch_inputs(rng, b, m=24, d_in=40, d_out=48, k=3):
    x = rng.normal(size=(b, m, d_in)).astype(np.float32)
    idx = rng.integers(0, d_in, size=(b, k, d_out)).astype(np.int32)
    val = rng.normal(size=(b, k, d_out)).astype(np.float32)
    return x, idx, val


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_sparse_delta_plain_matches_pallas_interpret_vmapped(b, dtype):
    x, idx, val = batch_inputs(np.random.default_rng(5), b)
    (jx, tx), (jv, tv) = both(x, dtype), both(val, dtype)
    kernel = functools.partial(sparse_delta_pallas, interpret=True)
    want = jax.vmap(kernel)(jx, jnp.asarray(idx), jv)  # as moe.py vmaps over experts
    reset_counters()
    got = sd.sparse_delta(tx, torch.from_numpy(idx), tv)
    assert got.dtype == tx.dtype and got.shape == (b, 24, 48)
    close(got, want, TOL[dtype])
    assert (COUNTERS["sparse_delta"].plain, COUNTERS["sparse_delta"].kernel) == (1, 0)
    # against the jnp oracle, batch by batch, in fp32
    if dtype == jnp.float32:
        for i in range(b):
            close(got[i], jref.sparse_delta_ref(jnp.asarray(x[i]), jnp.asarray(idx[i]),
                                                jnp.asarray(val[i])), 2e-5)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_batched_dval_plain_matches_reference(b, dtype):
    rng = np.random.default_rng(6)
    x, idx, _ = batch_inputs(rng, b)
    dy = rng.normal(size=(b, 24, 48)).astype(np.float32)
    (jx, tx), (jdy, tdy) = both(x, dtype), both(dy, dtype)
    kernel = functools.partial(sparse_delta_dval_pallas, interpret=True)
    want = jax.vmap(kernel)(jx, jnp.asarray(idx), jdy)
    got = sd.sparse_delta_dval(tx, torch.from_numpy(idx), tdy)
    assert got.dtype == torch.float32 and got.shape == (b, 3, 48)
    close(got, want, TOL[dtype])
    for i in range(b):  # each batch as the 2-D call
        close(got[i], sd.sparse_delta_dval(tx[i], torch.from_numpy(idx[i]), tdy[i]), 1e-6)


@pytest.mark.parametrize("expert_stack", [False, True], ids=["head", "experts"])
def test_delta_apply_gradient_matches_reference_vjp(expert_stack):
    """dx and dval of ``ops.delta_apply`` against ``jax.vjp`` of the
    reference's under its Pallas kernels (interpret mode), vmapped over the
    experts as ``moe.py`` does."""
    rng = np.random.default_rng(7)
    if expert_stack:
        x, idx, val = batch_inputs(rng, 4, m=10)
    else:
        x = rng.normal(size=(2, 5, 40)).astype(np.float32)
        idx = rng.integers(0, 40, size=(3, 48)).astype(np.int32)
        val = rng.normal(size=(3, 48)).astype(np.float32)
    dy = rng.normal(size=(*x.shape[:-1], 48)).astype(np.float32)
    fn = jax.vmap(jops.delta_apply) if expert_stack else jops.delta_apply
    with jops.use_backend("pallas_interpret"):
        jy, vjp = jax.vjp(lambda a, v: fn(a, jnp.asarray(idx), v), jnp.asarray(x),
                          jnp.asarray(val))
        want_dx, want_dval = vjp(jnp.asarray(dy))
    tx, tv = torch.from_numpy(x).requires_grad_(), torch.from_numpy(val).requires_grad_()
    reset_counters()
    y = ops.delta_apply(tx, torch.from_numpy(idx), tv)
    close(y, jy, 2e-5)
    y.backward(torch.from_numpy(dy))
    close(tx.grad, want_dx, 2e-5)
    close(tv.grad, want_dval, 2e-5)
    assert (COUNTERS["sparse_delta"].plain, COUNTERS["sparse_delta_dval"].plain) == (1, 1)


@pytest.mark.parametrize("case", ["rank", "batch", "dtype", "index_dtype", "contiguous"])
def test_sparse_delta_check_rejects_bad_inputs(case):
    x, idx, val = map(torch.from_numpy, batch_inputs(np.random.default_rng(8), 2))
    bad = {
        "rank": ((x[0], idx, val), ValueError),
        "batch": ((x, idx[:1], val[:1]), ValueError),
        "dtype": ((x.double(), idx, val), TypeError),
        "index_dtype": ((x, idx.long(), val), TypeError),
        "contiguous": ((x.transpose(1, 2).contiguous().transpose(1, 2), idx, val), ValueError),
    }
    args, err = bad[case]
    with pytest.raises(err):
        sd._check_delta(*args)
    sd._check_delta(x, idx, val)
    dy = torch.zeros(2, 24, 48)
    sd._check_dval(x, idx, dy)
    with pytest.raises(ValueError):
        sd._check_dval(x, idx[:1], dy)


@pytest.mark.parametrize("m,d_out,sms,batch,want", [
    (320, 1024, 132, 64, (107, 3)),   # olmoe expert wgate/wup: one span each
    (320, 2048, 132, 64, (107, 3)),   # olmoe expert wdown
    (2048, 50304, 132, 1, (187, 11)),  # the untied head: 13 spans of 3872 columns
    (2048, 256, 132, 1, (16, 128)),   # B = 1 is the 2-D split
])
def test_batched_dval_split_covers_every_row(m, d_out, sms, batch, want):
    plan = sd.dval_plan(batch, m, 2048, d_out, 2, sms)
    rows, n_split = plan.rows_per_range, plan.ranges
    assert (rows, n_split) == want
    assert rows * n_split >= m > rows * (n_split - 1)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cuda_sparse_delta_and_batched_dval_match_plain(cuda, dtype):
    """Ragged shapes (rows and columns not multiples of a tile; B = 1 and
    B = E), both value dtypes; the 2-D dval call equals the B = 1 call bit
    for bit."""
    rng = np.random.default_rng(9)
    tol = TOL[dtype]
    reset_counters()
    for b, m, d_in, d_out, k in ((1, 130, 77, 129, 1), (64, 7, 300, 260, 2), (3, 33, 1000, 5, 3)):
        x, idx, val = batch_inputs(rng, b, m, d_in, d_out, k)
        dy = (rng.normal(size=(b, m, d_out)) * m**-0.5).astype(np.float32)
        tx, tdy = both(x, dtype)[1].to(cuda), both(dy, dtype)[1].to(cuda)
        tidx = torch.from_numpy(idx).to(cuda)
        for vdt in (jnp.float32, jnp.bfloat16):
            tv = both(val, vdt)[1].to(cuda)
            close(sd.sparse_delta(tx, tidx, tv).cpu(), sd.sparse_delta_plain(tx, tidx, tv).cpu(),
                  tol)
        got = sd.sparse_delta_dval(tx, tidx, tdy)
        close(got.cpu(), sd.sparse_delta_dval_plain(tx, tidx, tdy).cpu(), tol)
        assert torch.equal(got, sd.sparse_delta_dval(tx, tidx, tdy))
        assert torch.equal(sd.sparse_delta_dval(tx[0], tidx[0], tdy[0]),
                           sd.sparse_delta_dval(tx[:1], tidx[:1], tdy[:1])[0])
    torch.cuda.synchronize()
    assert COUNTERS["sparse_delta"].kernel == COUNTERS["sparse_delta"].plain == 6
