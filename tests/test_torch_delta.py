"""The port's bypass apply with its serving epilogue, and the value
gradient in the values' dtype, against the JAX reference and against the
launches they replace, on the CPU.

* The fused epilogue's plain form (``y`` given) equals ``y + delta`` then
  ``+ bias.to(y.dtype)`` bit for bit, for x and the values in float32 and
  bf16, with and without a bias; per-sequence ids read with a rows-per-id
  stride equal per-row ids bit for bit, through the wrapper and through
  ``ops.delta_apply_batched``.
* The multi-tenant ``layers.alinear`` of reduced qwen2-1.5b and
  ``moe._expert_linear_g`` of reduced olmoe-1b-7b (the serving bypass,
  now in the epilogue) against ``repro.models.layers.alinear`` and
  ``repro.models.moe._expert_linear_g`` on the same numpy inputs, on the
  ``jnp`` and ``pallas_interpret`` backends (float32 2e-5, bf16 2e-2).
* ``delta_plan`` and ``dval_plan``, pure Python: at qwen2's 7 projections
  and olmoe's 4 shapes, at 8, 2048 and 4096 tokens, every row and column
  is covered once, shared memory fits 227 KB, and the grid fills 132 SMs
  as far as the work allows (the gradient's ranges to one rounding of
  their rows).
* ``sparse_delta_dval`` in the values' dtype equals the float32 result
  cast, and the bypass gradient of ``ops.delta_apply`` comes back in the
  values' dtype.
* The sparse dx (``ref.sparse_delta_dx_ref``, 2-D and batched) equals a
  sequential sum of each column's terms in (j, o) order bit for bit, with
  columns hit many times and not at all, and the reference's scatter-add;
  its column sort is kept for an ``idx`` (also across views of one place)
  and redone after an in-place change.

The ``gpu`` tests hold both CUDA kernels against their plain versions at
ragged and path-like shapes, the fused epilogue against the three launches
bit for bit, and two launches against each other bit for bit; they skip
without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.core.delta import BatchedDelta as JBatchedDelta
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as j_get_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.convert import to_tensor
from repro_torch.core.delta import BatchedDelta
from repro_torch.kernels import COUNTERS, ops, ref, reset_counters
from repro_torch.kernels import sparse_delta as sd
from repro_torch.models import layers, moe

torch.set_num_threads(2)
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}
DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SMEM = 232448  # shared memory a block may use (227 KB)
SMS = 132


def both(arr, dtype=jnp.float32):
    """The same values as a JAX array and a torch tensor (same bits)."""
    j = jnp.asarray(arr, dtype)
    return j, to_tensor(np.asarray(j))


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def tenant_stack(rng, n, k, d_in, d_out):
    idx = rng.integers(0, d_in, size=(n, k, d_out)).astype(np.int32)
    val = (0.1 * rng.normal(size=(n, k, d_out))).astype(np.float32)
    val[0] = 0.0  # tenant 0 is the base
    return idx, val


# ------------------------------------------------------------- the epilogue


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("v_dt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("x_dt", [jnp.float32, jnp.bfloat16])
def test_fused_epilogue_equals_the_three_launches(x_dt, v_dt, with_bias):
    rng = np.random.default_rng(1)
    m, d_in, d_out = 24, 40, 36
    idx, val = tenant_stack(rng, 3, 2, d_in, d_out)
    x = both(rng.normal(size=(m, d_in)), x_dt)[1]
    y0 = both(rng.normal(size=(m, d_out)), x_dt)[1]
    b = torch.from_numpy(rng.normal(size=(d_out,)).astype(np.float32))  # cast by the callee
    tv = both(val, v_dt)[1]
    aid = torch.from_numpy(rng.integers(0, 3, size=(m,)).astype(np.int32))
    tidx = torch.from_numpy(idx)
    want = y0 + sd.sparse_delta_batched(x, tidx, tv, aid)
    if with_bias:
        want = want + b.to(want.dtype)
    y = y0.clone()
    got = sd.sparse_delta_batched(x, tidx, tv, aid, 1, y, b if with_bias else None)
    assert got is y and got.dtype == DT[x_dt]
    assert torch.equal(got, want)
    # through ops, on (B, S, d_in) rows with per-sequence ids
    x3, y3 = x.reshape(4, 6, d_in), y0.clone().reshape(4, 6, d_out)
    aid3 = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    want3 = y3 + ops.delta_apply_batched(x3, tidx, tv, aid3)
    if with_bias:
        want3 = want3 + b.to(want3.dtype)
    got3 = ops.delta_apply_batched(x3, tidx, tv, aid3, y3, b if with_bias else None)
    assert got3 is y3 and torch.equal(got3, want3)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("x_dt", [jnp.float32, jnp.bfloat16])
def test_per_sequence_ids_equal_per_row_ids(x_dt, fused):
    rng = np.random.default_rng(2)
    b_, s, d_in, d_out = 3, 5, 32, 24
    idx, val = tenant_stack(rng, 4, 3, d_in, d_out)
    x = both(rng.normal(size=(b_ * s, d_in)), x_dt)[1]
    tidx, tv = torch.from_numpy(idx), both(val, x_dt)[1]
    seq = torch.tensor([3, 1, 0], dtype=torch.int32)
    rows = seq.repeat_interleave(s)
    y0 = both(rng.normal(size=(b_ * s, d_out)), x_dt)[1]
    kw = lambda: (y0.clone(),) if fused else ()  # noqa: E731
    by_seq = sd.sparse_delta_batched(x, tidx, tv, seq, s, *kw())
    by_row = sd.sparse_delta_batched(x, tidx, tv, rows, 1, *kw())
    assert torch.equal(by_seq, by_row)
    # ops: (B,) ids against (B, S) rows stride; (B, S) ids are per row
    got = ops.delta_apply_batched(x.reshape(b_, s, d_in), tidx, tv, seq)
    want = ops.delta_apply_batched(x.reshape(b_, s, d_in), tidx, tv,
                                   rows.reshape(b_, s))
    assert torch.equal(got, want)


def test_epilogue_refuses_a_y_that_requires_grad_and_bad_shapes():
    rng = np.random.default_rng(3)
    idx, val = tenant_stack(rng, 2, 1, 8, 16)
    x = torch.randn(4, 8)
    tidx, tv = torch.from_numpy(idx), torch.from_numpy(val)
    aid = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="requires grad"):
        sd.sparse_delta_batched(x, tidx, tv, aid, 1, torch.zeros(4, 16, requires_grad=True))
    y = torch.zeros(4, 16)
    sd._check(x, tidx, tv, aid, 1, y, torch.zeros(16))
    sd._check(x, tidx, tv, aid[:2], 2)
    for args, err in (((aid[:3], 1), ValueError),            # ids do not cover the rows
                      ((aid, 1, y[:, :8]), ValueError),      # y is not (M, d_out)
                      ((aid, 1, y.double()), ValueError),    # y not in x's dtype
                      ((aid, 1, None, torch.zeros(16)), ValueError),  # a bias without y
                      ((aid, 1, y, torch.zeros(8)), ValueError)):
        with pytest.raises(err):
            sd._check(x, tidx, tv, *args)


# ------------------------------------------------- the layers vs the reference


@pytest.fixture(scope="module")
def qwen2_layer():
    """Reduced qwen2-1.5b's layer-0 params: (the reference's, as numpy)."""
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jp = j_get_model(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda x: np.asarray(x[0]), jp["blocks"])


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("name", ["wq", "wdown"])
def test_multitenant_alinear_matches_reference(qwen2_layer, name, dtype, backend):
    """A (B, S, d_in) chunk through one projection with a bias (wq) or
    without (wdown), 3 tenants + base per sequence, the bypass and the bias
    in the epilogue."""
    rng = np.random.default_rng(4)
    leaf = {key: v for key, v in qwen2_layer[name].items()}
    d_in, d_out = leaf["w"].shape
    idx, val = tenant_stack(rng, 4, 2, d_in, d_out)
    aid = np.array([2, 0, 3, 1], np.int32)
    x = rng.normal(size=(4, 6, d_in)).astype(np.float32)
    jp = {name: {key: both(v, dtype)[0] for key, v in leaf.items()}}
    tp = {name: {key: both(v, dtype)[1] for key, v in leaf.items()}}
    jx, tx = both(x, dtype)
    ja = {name: JBatchedDelta(jnp.asarray(idx), both(val, dtype)[0], jnp.asarray(aid))}
    ta = {name: BatchedDelta(torch.from_numpy(idx), both(val, dtype)[1], torch.from_numpy(aid))}
    with jops.use_backend(backend):
        want = jlayers.alinear(jp, ja, name, jx)
    reset_counters()
    got = layers.alinear(tp, ta, name, tx)
    assert got.shape == tuple(want.shape) and got.dtype == DT[dtype]
    close(got, want, TOL[dtype])
    assert COUNTERS["sparse_delta_batched"].plain == 1  # one call: the epilogue


@pytest.fixture(scope="module")
def olmoe_layer():
    cfg = reduced(get_config("olmoe-1b-7b")).replace(dtype="float32")
    jp = j_get_model(cfg).init(jax.random.PRNGKey(0))
    return cfg, jax.tree.map(lambda x: np.asarray(x[0]), jp["blocks"])


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_expert_linear_g_matches_reference(olmoe_layer, dtype, backend):
    """The expert stacks' serving bypass: the reference's (G, E, C, D)
    buffers and (G, E, C) tenant ids laid out as the port's (E, G·C, D)
    buffers and combined ids tenant · E + e."""
    cfg, p0 = olmoe_layer
    rng = np.random.default_rng(5)
    g, c, n = 2, 3, 3
    e = cfg.num_experts
    tenant = rng.integers(0, n, size=(g, e, c)).astype(np.int32)
    port_aid = (tenant.transpose(1, 0, 2).reshape(e, g * c) * e
                + np.arange(e, dtype=np.int32)[:, None]).astype(np.int32)
    for name in ("wgate", "wup", "wdown"):
        w = p0[name]["w"]
        d_in, d_out = w.shape[1:]
        idx = rng.integers(0, d_in, size=(n, e, 2, d_out)).astype(np.int32)
        val = (0.1 * rng.normal(size=(n, e, 2, d_out))).astype(np.float32)
        val[0] = 0.0
        eh = rng.normal(size=(g, e, c, d_in)).astype(np.float32)
        jeh, teh = both(eh, dtype)
        ja = {name: JBatchedDelta(jnp.asarray(idx), both(val, dtype)[0], None)}
        ta = {name: BatchedDelta(torch.from_numpy(idx), both(val, dtype)[1], None)}
        with jops.use_backend(backend):
            want = jmoe._expert_linear_g({name: {"w": both(w, dtype)[0]}}, ja, name, jeh,
                                         jnp.asarray(tenant))
        got = moe._expert_linear_g({name: {"w": both(w, dtype)[1]}}, ta, name,
                                   teh.transpose(0, 1).reshape(e, g * c, d_in).contiguous(),
                                   torch.from_numpy(port_aid))
        got = got.reshape(e, g, c, d_out).transpose(0, 1)
        close(got, want, TOL[dtype])


# ----------------------------------------------------------------- the plans


def shapes():
    """(model, projection, batch, rows a batch entry at `tokens` tokens,
    d_in, d_out): qwen2-1.5b's 7 projections; olmoe-1b-7b's 3 expert stacks
    (64 experts, top 8, capacity factor 1.25) and its untied head."""
    qwen = [("wq", 1536, 1536), ("wk", 1536, 256), ("wv", 1536, 256), ("wo", 1536, 1536),
            ("wgate", 1536, 8960), ("wup", 1536, 8960), ("wdown", 8960, 1536)]
    out = [("qwen2", n, lambda t: (1, t), d_in, d_out) for n, d_in, d_out in qwen]
    expert = lambda t: (64, -(-t * 8 * 5 // (64 * 4))) # noqa: E731
    out += [("olmoe", "wgate", expert, 2048, 1024), ("olmoe", "wup", expert, 2048, 1024),
            ("olmoe", "wdown", expert, 1024, 2048),
            ("olmoe", "head", lambda t: (1, t), 2048, 50304)]
    return out


@pytest.mark.parametrize("tokens", [8, 2048, 4096])
@pytest.mark.parametrize("case", shapes(), ids=lambda c: f"{c[0]}-{c[1]}")
def test_plans_cover_fit_and_fill(case, tokens):
    _, _, rows_of, d_in, d_out = case
    b, m = rows_of(tokens)
    groups = -(-d_out // sd.COLS)
    for es in (2, 4):
        # the apply, over all B x M rows
        p = sd.delta_plan(b * m, d_in, d_out, es, SMS)
        work = b * m * groups
        if p.route == "rows":
            assert b * m <= sd.ROWS_MAX
            assert p.threads % 32 == 0 and 32 <= p.threads <= sd.ROW_THREADS
            assert p.blocks * p.threads >= work > (p.blocks - 1) * p.threads
            assert p.blocks >= min(SMS, -(-work // 32))
        else:
            assert p.groups * p.spans >= groups > p.groups * (p.spans - 1)
            assert p.lanes * p.groups <= p.threads <= sd.APPLY_THREADS and p.threads % 32 == 0
            assert p.blocks % p.spans == 0
            ranges = p.blocks // p.spans
            rows = -(-b * m // ranges)  # the kernel's rows a range
            assert ranges * rows >= b * m
            assert 1 <= p.tile_rows <= rows and p.blocks <= 4 * SMS + p.spans
            assert p.blocks >= min(SMS, p.spans * -(-b * m // p.lanes))
            assert p.smem == p.stages * sd.stage_bytes(p.tile_rows, d_in, es) <= SMEM - 1024
            # a whole staged run, ends off 16-byte alignment included, fits its buffer
            assert sd.stage_bytes(p.tile_rows, d_in, es) >= p.tile_rows * d_in * es + 15
        # the gradient
        q = sd.dval_plan(b, m, d_in, d_out, es, SMS)
        assert q.groups * q.spans >= groups > q.groups * (q.spans - 1)
        assert q.lanes * q.groups <= q.threads <= sd.DVAL_THREADS and q.threads % 32 == 0
        assert q.rows_per_range * q.ranges >= m > q.rows_per_range * (q.ranges - 1)
        assert 1 <= q.tile_rows <= q.rows_per_range
        red = q.lanes * q.groups * sd.COLS * 4 if q.lanes > 1 else 0
        assert q.smem == q.stages * sd.stage_bytes(q.tile_rows, d_in, es) + red <= SMEM - 1024
        # rows a range are whole: the ranges fill the card to one rounding
        assert b * q.spans * q.ranges >= min(0.9 * SMS, b * q.spans * m)


# ----------------------------------------------------------- the gradient


@pytest.mark.parametrize("v_dt", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("x_dt", [jnp.float32, jnp.bfloat16])
def test_dval_in_values_dtype_equals_the_cast(x_dt, v_dt):
    rng = np.random.default_rng(6)
    x = both(rng.normal(size=(3, 20, 30)), x_dt)[1]
    dy = both(rng.normal(size=(3, 20, 17)) / 20**0.5, x_dt)[1]
    idx = torch.from_numpy(rng.integers(0, 30, size=(3, 2, 17)).astype(np.int32))
    got = sd.sparse_delta_dval(x, idx, dy, DT[v_dt])
    assert got.dtype == DT[v_dt]
    assert torch.equal(got, sd.sparse_delta_dval_plain(x, idx, dy).to(DT[v_dt]))
    assert torch.equal(sd.sparse_delta_dval(x[0], idx[0], dy[0], DT[v_dt]), got[:1][0])
    # the autograd backward asks for the values' dtype
    val = both(rng.normal(size=(3, 2, 17)) * 0.1, v_dt)[1].requires_grad_()
    ops.delta_apply(x, idx, val).backward(dy)
    assert val.grad.dtype == DT[v_dt]
    assert torch.equal(val.grad, got)


def _dx_in_order(idx, val, dy, d_in):
    """The sparse dx as a sequential loop: each column's terms added to 0 in
    (j, o) order, in float32."""
    dx = torch.zeros(dy.shape[0], d_in)
    for j in range(idx.shape[0]):
        for o in range(idx.shape[1]):
            dx[:, idx[j, o]] += dy[:, o].float() * val[j, o].float()
    return dx


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("batch", [None, 3])
def test_sparse_dx_sums_each_column_in_order(batch, dtype):
    # k·d_out = 26 terms over columns 0-4 of d_in 6: each column is hit
    # about five times, the last one never
    rng = np.random.default_rng(8)
    b, m, k, d_in, d_out = batch or 1, 9, 2, 6, 13
    idx = np.stack([np.stack([rng.permutation(d_in - 1)[:k] for _ in range(d_out)], 1)
                    for _ in range(b)]).astype(np.int32)
    val = both(rng.normal(size=(b, k, d_out)), dtype)[1]
    dy = both(rng.normal(size=(b, m, d_out)), dtype)[1]
    ti = torch.from_numpy(idx)
    want = torch.stack([_dx_in_order(ti[i], val[i], dy[i], d_in) for i in range(b)])
    if batch is None:
        got = ref.sparse_delta_dx_ref(ti[0], val[0], dy[0], d_in)
        assert got.shape == (m, d_in) and torch.equal(got, want[0])
        oracle = jref.sparse_delta_dx_ref(jnp.asarray(idx[0]), jnp.asarray(val[0].float().numpy()),
                                          jnp.asarray(dy[0].float().numpy()), d_in)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=2e-6, atol=2e-6)
    else:
        got = ref.sparse_delta_dx_ref(ti, val, dy, d_in)
        assert got.shape == (b, m, d_in) and torch.equal(got, want)
    # the column sort is kept for the tensor, found again from a new view of
    # the same place, and made anew after an in-place change
    idx_t = ti if batch else ti[0]
    plan = ref._dx_plan(idx_t, d_in)
    assert ref._dx_plan(idx_t, d_in) is plan
    assert ref._dx_plan(ti if batch else ti[0], d_in) is plan
    if not batch:
        assert ref._dx_plan(ti[0], d_in - 1) is not plan
    idx_t[..., 0, 0] = d_in - 1
    assert ref._dx_plan(idx_t, d_in) is not plan
    got = ref.sparse_delta_dx_ref(idx_t, val if batch else val[0], dy if batch else dy[0], d_in)
    want = torch.stack([_dx_in_order(ti[i], val[i], dy[i], d_in) for i in range(b)])
    assert torch.equal(got, want if batch else want[0])


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("x_dt", [torch.float32, torch.bfloat16])
def test_cuda_apply_routes_and_epilogue_match_plain(cuda, x_dt):
    """Both routes (8 and 300 rows), ragged d_out (36) and d_in (77), the
    fused epilogue bit for bit against the kernel's delta plus PyTorch's two
    adds, two launches bit for bit, per-sequence ids."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    tol = TOL[jnp.float32 if x_dt == torch.float32 else jnp.bfloat16]
    for m, d_in, d_out, k in ((8, 77, 36, 1), (300, 1536, 256, 2), (300, 77, 36, 3),
                              (130, 1000, 264, 2)):
        for v_dt in (torch.float32, torch.bfloat16):
            x = torch.randn(m, d_in, generator=gen, device=cuda).to(x_dt)
            idx = torch.randint(0, d_in, (3, k, d_out), generator=gen, device=cuda,
                                dtype=torch.int32)
            val = (torch.randn(3, k, d_out, generator=gen, device=cuda) * 0.1).to(v_dt)
            aid = torch.randint(0, 3, (m,), generator=gen, device=cuda, dtype=torch.int32)
            y0 = torch.randn(m, d_out, generator=gen, device=cuda).to(x_dt)
            b = torch.randn(d_out, generator=gen, device=cuda).to(x_dt)
            reset_counters()
            got = sd.sparse_delta_batched(x, idx, val, aid)
            close(got.cpu(), sd.sparse_delta_batched_plain(x, idx, val, aid).cpu(), tol)
            assert torch.equal(got, sd.sparse_delta_batched(x, idx, val, aid))
            fused = sd.sparse_delta_batched(x, idx, val, aid, 1, y0.clone(), b)
            assert torch.equal(fused, (y0 + got) + b)
            route = sd.delta_plan(m, d_in, d_out, x.element_size(),
                                  torch.cuda.get_device_properties(cuda).multi_processor_count
                                  ).route
            assert COUNTERS["sparse_delta_batched"].routes == {route: 2, route + "-fused": 1}
            if m % 4 == 0:
                seq = aid[:: m // 4].contiguous()
                assert torch.equal(sd.sparse_delta_batched(x, idx, val, seq, m // 4),
                                   sd.sparse_delta_batched(
                                       x, idx, val, seq.repeat_interleave(m // 4)))


@pytest.mark.gpu
@pytest.mark.parametrize("x_dt", [torch.float32, torch.bfloat16])
def test_cuda_dval_single_launch_matches_plain(cuda, x_dt):
    """One range, one merge group, two levels of merge; ragged d_out; the
    values' dtype equal to the float32 result cast; two launches bit for
    bit; the 2-D call equal to the B = 1 call."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    tol = TOL[jnp.float32 if x_dt == torch.float32 else jnp.bfloat16]
    for b, m, d_in, d_out, k in ((1, 3, 77, 129, 1), (1, 2048, 1536, 256, 1),
                                 (1, 2048, 1536, 1536, 2), (64, 40, 300, 260, 3),
                                 (3, 500, 1000, 36, 5)):
        x = torch.randn(b, m, d_in, generator=gen, device=cuda).to(x_dt)
        idx = torch.randint(0, d_in, (b, k, d_out), generator=gen, device=cuda,
                            dtype=torch.int32)
        dy = (torch.randn(b, m, d_out, generator=gen, device=cuda) * m**-0.5).to(x_dt)
        reset_counters()
        got = sd.sparse_delta_dval(x, idx, dy)
        close(got.cpu(), sd.sparse_delta_dval_plain(x, idx, dy).cpu(), tol)
        assert torch.equal(got, sd.sparse_delta_dval(x, idx, dy))
        assert torch.equal(sd.sparse_delta_dval(x, idx, dy, torch.bfloat16),
                           got.to(torch.bfloat16))
        assert torch.equal(sd.sparse_delta_dval(x[0], idx[0], dy[0]),
                           sd.sparse_delta_dval(x[:1], idx[:1], dy[:1])[0])
        assert COUNTERS["sparse_delta_dval"].routes == {sd.DVAL_ROUTE: 5}
