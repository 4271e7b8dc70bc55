"""Kernel modules of the PyTorch port against the JAX reference.

Serving kernels (sparse_delta_batched, paged decode and prefill attention),
training kernels (fused_linear, sparse_delta_dval, and the gradient of
``ops.fused_linear`` against ``jax.vjp`` of the reference's) and the
packed-base kernel (fused_linear_q, int8 and NF4, and the gradient of
``ops.fused_linear_q`` against the reference's custom VJP).

On the CPU each wrapper runs its kernel's plain PyTorch version. Those are
held against the reference's jnp oracles in fp32 and against its Pallas
kernels in interpret mode in fp32 and bf16 (the repo's tolerances: 2e-5 and
2e-2), over GQA groups 1/2/4, ragged offsets and frontiers, idle slots, and
shared and sentinel table entries. Inputs are made with numpy and fed to
both packages. The CUDA kernels themselves are held against the plain
versions by the ``gpu`` tests, which skip without a card.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_attention_pallas
from repro.kernels.fused_linear import fused_linear_pallas
from repro.kernels.prefill_attention import paged_prefill_attention_pallas
from repro.kernels.quant_linear import fused_linear_q_pallas
from repro.kernels.sparse_delta import sparse_delta_batched_pallas, sparse_delta_dval_pallas
from repro.quant import quantize as j_quantize
from repro_torch.convert import to_tensor
from repro_torch.kernels import (
    ATTENTION,
    COUNTERS,
    LONG_CONTEXT,
    PACKED_BASE,
    SELECTION,
    SERVING,
    SINGLE_TENANT,
    TENSOR_PARALLEL,
    TRAINING,
    build,
    ops,
    reset_counters,
)
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import fused_linear as fl
from repro_torch.kernels import prefill_attention as pre
from repro_torch.kernels import quant_linear as ql
from repro_torch.kernels import sparse_delta as sd
from repro_torch.quant import QuantizedTensor

torch.set_num_threads(2)
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def both(arr, dtype):
    """The same values as a JAX array and a torch tensor (same bits)."""
    j = jnp.asarray(arr, dtype)
    return j, to_tensor(np.asarray(j))


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------- sparse delta


def delta_inputs(rng, m=16, d_in=24, d_out=40, n=3, k=3):
    x = rng.normal(size=(m, d_in)).astype(np.float32)
    idx = rng.integers(0, d_in, size=(n, k, d_out)).astype(np.int32)
    val = rng.normal(size=(n, k, d_out)).astype(np.float32)
    val[0] = 0.0
    aid = rng.integers(0, n, size=(m,)).astype(np.int32)
    return x, idx, val, aid


def test_sparse_delta_plain_matches_jnp_oracle():
    x, idx, val, aid = delta_inputs(np.random.default_rng(0))
    want = jref.sparse_delta_batched_ref(jnp.asarray(x), jnp.asarray(idx),
                                         jnp.asarray(val), jnp.asarray(aid))
    got = sd.sparse_delta_batched(*map(torch.from_numpy, (x, idx, val, aid)))
    close(got, want, 2e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_sparse_delta_plain_matches_pallas_interpret(dtype):
    x, idx, val, aid = delta_inputs(np.random.default_rng(1))
    jx, tx = both(x, dtype)
    jv, tv = both(val, dtype)
    want = sparse_delta_batched_pallas(jx, jnp.asarray(idx), jv, jnp.asarray(aid),
                                       interpret=True)
    got = sd.sparse_delta_batched(tx, torch.from_numpy(idx), tv, torch.from_numpy(aid))
    assert got.dtype == tx.dtype
    close(got, want, TOL[dtype])


def test_delta_apply_batched_broadcasts_slot_ids_like_reference():
    """(B, S, d_in) activations with one tenant id per slot (B,)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    _, idx, val, _ = delta_inputs(rng)
    aid = np.array([2, 0, 1], np.int32)
    want = jops.delta_apply_batched(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(val),
                                    jnp.asarray(aid))
    got = ops.delta_apply_batched(*map(torch.from_numpy, (x, idx, val, aid)))
    assert got.shape == (3, 5, 40)
    close(got, want, 2e-5)


# ------------------------------------------------------- paged attention


def paged_inputs(rng, g, c, dtype, b=4, hkv=2, hd=16, page=4, n_pages=6, nblk=14):
    """Ragged frontiers, slot 1 sharing slot 0's leading pages, sentinel
    (``nblk``) entries past every frontier, slot 3 idle (frontier 0)."""
    h = g * hkv
    q = rng.normal(size=(b, c, h, hd))
    kp = rng.normal(size=(nblk, page, hkv, hd))
    vp = rng.normal(size=(nblk, page, hkv, hd))
    q_len = np.array([c, max(c - 1, 1), 1, 0], np.int32)[:b]
    q_off = np.array([page * n_pages - c, 3, 9, 0], np.int32)[:b]
    vl = q_off + q_len
    table = np.full((b, n_pages), nblk, np.int32)
    perm = list(rng.permutation(nblk))
    for s in range(b):
        used = -(-int(vl[s]) // page)
        table[s, :used] = [perm.pop() for _ in range(used)]
    table[1, :2] = table[0, :2]
    jq, tq = both(q, dtype)
    jk, tk = both(kp, dtype)
    jv, tv = both(vp, dtype)
    ints = [(jnp.asarray(a), torch.from_numpy(a)) for a in (table, q_off, vl)]
    return (jq, jk, jv, *[j for j, _ in ints]), (tq, tk, tv, *[t for _, t in ints])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_decode_plain_matches_jnp_oracle(g):
    (jq, jk, jv, jt, _, jvl), (tq, tk, tv, tt, _, tvl) = paged_inputs(
        np.random.default_rng(10 + g), g, 1, jnp.float32)
    want = jref.paged_decode_attention_ref(jq, jk, jv, jt, jvl)
    got = dec.paged_decode_attention(tq, tk, tv, tt, tvl)
    close(got, want, 2e-5)
    assert not got[3].any(), "a slot with an empty frontier gets zeros"


# (g, hkv, hd): GQA groups 1/2/4 at small heads, and olmoe-1b-7b's layout
# (16 query heads on 16 kv heads, hd 128)
DECODE_LAYOUTS = [(1, 2, 16), (2, 2, 16), (4, 2, 16), (1, 16, 128)]


@pytest.mark.parametrize("g,hkv,hd", DECODE_LAYOUTS, ids=["1", "2", "4", "olmoe"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_plain_matches_pallas_interpret(g, hkv, hd, dtype):
    """Frontiers cross pages (24, 4 and 10 rows of 4-row pages)."""
    (jq, jk, jv, jt, _, jvl), (tq, tk, tv, tt, _, tvl) = paged_inputs(
        np.random.default_rng(20 + g), g, 1, dtype, b=3, hkv=hkv, hd=hd)
    want = paged_decode_attention_pallas(jq, jk, jv, jt, jvl, interpret=True)
    got = dec.paged_decode_attention(tq, tk, tv, tt, tvl)
    assert got.dtype == tq.dtype
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("g", [1, 2, 4])
def test_prefill_plain_matches_jnp_oracle(g):
    (jq, jk, jv, jt, jo, jvl), (tq, tk, tv, tt, to, tvl) = paged_inputs(
        np.random.default_rng(30 + g), g, 5, jnp.float32)
    want = jref.paged_prefill_attention_ref(jq, jk, jv, jt, jo, jvl)
    got = pre.paged_prefill_attention(tq, tk, tv, tt, to, tvl)
    close(got, want, 2e-5)
    assert not got[3].any(), "an idle slot (q_len 0, frontier 0) gets zeros"


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_prefill_plain_matches_pallas_interpret(g, dtype):
    (jq, jk, jv, jt, jo, jvl), (tq, tk, tv, tt, to, tvl) = paged_inputs(
        np.random.default_rng(40 + g), g, 6, dtype)
    want = paged_prefill_attention_pallas(jq, jk, jv, jt, jo, jvl, interpret=True)
    got = pre.paged_prefill_attention(tq, tk, tv, tt, to, tvl)
    close(got, want, TOL[dtype])


def test_ops_accept_scalar_lengths_like_reference():
    """The reference's ops broadcast a scalar offset/length; the port's take
    the (B,) int32 tensors the engine builds, here filled with that scalar."""
    (jq, jk, jv, jt, _, _), (tq, tk, tv, tt, _, _) = paged_inputs(
        np.random.default_rng(50), 2, 3, jnp.float32)
    per_slot = lambda v: torch.full((tq.shape[0],), v, dtype=torch.int32)  # noqa: E731
    want = jops.prefill_attention(jq, jk, jv, jt, 4, 7)
    got = ops.prefill_attention(tq, tk, tv, tt, per_slot(4), per_slot(7))
    close(got, want, 2e-5)
    want = jops.paged_decode_attention(jq[:, :1], jk, jv, jt, 9)
    got = ops.paged_decode_attention(tq[:, :1], tk, tv, tt, per_slot(9))
    close(got, want, 2e-5)


# ------------------------------------------------------ training kernels


def linear_inputs(rng, m=24, kd=40, n=48, k=3):
    x = rng.normal(size=(m, kd)).astype(np.float32)
    w = (rng.normal(size=(kd, n)) * kd**-0.5).astype(np.float32)
    idx = np.stack([rng.permutation(kd)[:k] for _ in range(n)], axis=1).astype(np.int32)
    val = (0.1 * rng.normal(size=(k, n))).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, idx, val, b


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_linear_plain_matches_pallas_interpret(dtype, bias):
    x, w, idx, val, b = linear_inputs(np.random.default_rng(20))
    (jx, tx), (jw, tw), (jv, tv), (jb, tb) = (both(a, dtype) for a in (x, w, val, b))
    if not bias:
        jb = tb = None
    want = fused_linear_pallas(jx, jw, jnp.asarray(idx), jv, jb, interpret=True)
    got = fl.fused_linear(tx, tw, torch.from_numpy(idx), tv, tb)
    assert got.dtype == tx.dtype and got.shape == (24, 48)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_sparse_delta_dval_plain_matches_pallas_interpret(dtype):
    rng = np.random.default_rng(21)
    x, _, idx, _, _ = linear_inputs(rng)
    dy = rng.normal(size=(24, 48)).astype(np.float32)
    jx, tx = both(x, dtype)
    jdy, tdy = both(dy, dtype)
    want = sparse_delta_dval_pallas(jx, jnp.asarray(idx), jdy, interpret=True)
    got = sd.sparse_delta_dval(tx, torch.from_numpy(idx), tdy)
    assert got.dtype == torch.float32 and got.shape == idx.shape
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fused_linear_gradient_matches_reference_vjp(dtype):
    """dx, dval and dbias of ``ops.fused_linear`` against ``jax.vjp`` of the
    reference's under its Pallas kernels (interpret mode); W gets none."""
    rng = np.random.default_rng(22)
    x, w, idx, val, b = linear_inputs(rng)
    x = x.reshape(2, 12, 40)
    dy = rng.normal(size=(2, 12, 48)).astype(np.float32)
    (jx, tx), (jw, tw), (jv, tv), (jb, tb), (jdy, tdy) = (
        both(a, dtype) for a in (x, w, val, b, dy))
    jidx, tidx = jnp.asarray(idx), torch.from_numpy(idx)
    with jops.use_backend("pallas_interpret"):
        jy, vjp = jax.vjp(lambda a, v, c: jops.fused_linear(a, jw, jidx, v, c, w_frozen=True),
                          jx, jv, jb)
        want_dx, want_dval, want_db = vjp(jdy)
    tx, tv, tb = (t.requires_grad_() for t in (tx, tv, tb))
    y = ops.fused_linear(tx, tw, tidx, tv, tb, w_frozen=True)
    close(y.detach(), jy, TOL[dtype])
    y.backward(tdy)
    assert tw.grad is None and not tw.requires_grad
    assert tv.grad.dtype == tv.dtype and tb.grad.dtype == tb.dtype
    close(tx.grad, want_dx, TOL[dtype])
    close(tv.grad, want_dval, TOL[dtype])
    close(tb.grad, want_db, TOL[dtype])


def test_training_wrappers_check_their_inputs():
    x, w, idx, val, b = map(torch.from_numpy, linear_inputs(np.random.default_rng(23)))
    fl._check(x, w, idx, val, b)
    with pytest.raises(ValueError):
        fl._check(x, w[:-1], idx, val, b)  # K does not chain
    with pytest.raises(TypeError):
        fl._check(x, w.bfloat16(), idx, val, b)
    with pytest.raises(TypeError):
        fl._check(x, w, idx.long(), val, b)
    with pytest.raises(ValueError):
        fl._check(x, w, idx, val, b[:-1])
    dy = torch.zeros(24, 48)
    sd._check_dval(x, idx, dy)
    with pytest.raises(ValueError):
        sd._check_dval(x, idx, dy[:-1])
    with pytest.raises(TypeError):
        sd._check_dval(x, idx, dy.bfloat16())


@pytest.mark.parametrize("m,d_out,sms,want", [
    (2048, 256, 132, (16, 128)),     # wk/wv: one span, M split 128 ways
    (2048, 8960, 132, (47, 44)),     # wgate/wup: 3 spans of 2992 columns
    (5, 8960, 132, (1, 5)),          # fewer rows than ranges wanted
])
def test_dval_split_fills_the_card_and_covers_every_row(m, d_out, sms, want):
    plan = sd.dval_plan(1, m, 1536, d_out, 2, sms)
    rows, n_split = plan.rows_per_range, plan.ranges
    assert (rows, n_split) == want
    assert rows * n_split >= m > rows * (n_split - 1)
    assert plan.spans * n_split >= min(m, 0.9 * sms)  # whole rows a range: one rounding


# ------------------------------------------------------ packed base


def packed_inputs(rng, qdtype, dtype, block=32, m=24, kd=64, n=48, k=3):
    """Linear inputs with W packed by the reference's quantizer: the JAX
    packed tensor and the port's, the same bytes."""
    x, w, idx, val, b = linear_inputs(rng, m, kd, n, k)
    jq = j_quantize(jnp.asarray(w, dtype), qdtype, block)
    tq = QuantizedTensor(to_tensor(np.asarray(jq.data)), to_tensor(np.asarray(jq.scales)),
                         qdtype, block, jq.dtype_name)
    return (x, idx, val, b), jq, tq


def rel_err(got, want) -> float:
    """The reference quant-kernel tests' measure: max |diff| / max |want|."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_fused_linear_q_plain_matches_jnp_oracle(qdtype, bias):
    (x, idx, val, b), jq, tq = packed_inputs(np.random.default_rng(30), qdtype, jnp.float32)
    jb, tb = (jnp.asarray(b), torch.from_numpy(b)) if bias else (None, None)
    want = jops.fused_linear_q(jnp.asarray(x), jq, jnp.asarray(idx), jnp.asarray(val), jb)
    got = ql.fused_linear_q(torch.from_numpy(x), tq.data, tq.scales, torch.from_numpy(idx),
                            torch.from_numpy(val), tb, qdtype=qdtype, block=32)
    assert got.dtype == torch.float32 and got.shape == (24, 48)
    close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_fused_linear_q_plain_matches_pallas_interpret(qdtype, dtype):
    """Against the Pallas kernel in interpret mode, with and without a
    bypass (``matmul_q``'s k = 0 is the reference's zero bypass): the
    reference kernel test's 1e-2 relative bound. The Pallas kernel
    multiplies by the float32 dequantized tile; the port rounds it to x's
    dtype first, as the reference's jnp path does."""
    (x, idx, val, b), jq, tq = packed_inputs(np.random.default_rng(31), qdtype, dtype)
    (jx, tx), (jv, tv), (jb, tb) = (both(a, dtype) for a in (x, val, b))
    want = fused_linear_q_pallas(jx, jq.data, jq.scales, jnp.asarray(idx), jv, jb,
                                 qdtype=qdtype, block=32, interpret=True)
    got = ql.fused_linear_q(tx, tq.data, tq.scales, torch.from_numpy(idx), tv, tb,
                            qdtype=qdtype, block=32)
    assert got.dtype == tx.dtype
    assert rel_err(got, want) <= 1e-2
    zero = jnp.zeros((1, 48), jnp.int32), jnp.zeros((1, 48), dtype)
    want = fused_linear_q_pallas(jx, jq.data, jq.scales, *zero, None, qdtype=qdtype,
                                 block=32, interpret=True)
    got = ops.matmul_q(tx, tq)
    assert rel_err(got, want) <= 1e-2


@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_fused_linear_q_gradient_matches_reference_vjp(qdtype):
    """dx, dval and dbias of ``ops.fused_linear_q`` against ``jax.vjp`` of
    the reference's custom VJP under its Pallas kernels (interpret mode),
    fp32, rtol 1e-4; the packed codes and scales get no gradient."""
    rng = np.random.default_rng(32)
    (x, idx, val, b), jq, tq = packed_inputs(rng, qdtype, jnp.float32)
    x = x.reshape(2, 12, 64)
    dy = rng.normal(size=(2, 12, 48)).astype(np.float32)
    jidx, tidx = jnp.asarray(idx), torch.from_numpy(idx)
    with jops.use_backend("pallas_interpret"):
        jy, vjp = jax.vjp(lambda a, v, c: jops.fused_linear_q(a, jq, jidx, v, c),
                          jnp.asarray(x), jnp.asarray(val), jnp.asarray(b))
        want_dx, want_dval, want_db = vjp(jnp.asarray(dy))
    tx, tv, tb = (torch.from_numpy(a).requires_grad_() for a in (x, val, b))
    reset_counters()
    y = ops.fused_linear_q(tx, tq, tidx, tv, tb)
    close(y.detach(), jy, 1e-4)
    y.backward(torch.from_numpy(dy))
    assert not tq.data.requires_grad and not tq.scales.requires_grad
    assert (COUNTERS["fused_linear_q"].plain, COUNTERS["sparse_delta_dval"].plain) == (1, 1)
    for got, want in ((tx.grad, want_dx), (tv.grad, want_dval), (tb.grad, want_db)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(want)).max())


def test_matmul_q_takes_plain_and_packed_weights():
    (x, _, _, _), _, tq = packed_inputs(np.random.default_rng(33), "nf4", jnp.float32)
    tx = torch.from_numpy(x).reshape(2, 12, 64).requires_grad_()
    w = torch.randn(64, 48)
    assert torch.equal(ops.matmul_q(tx, w), tx @ w)
    y = ops.matmul_q(tx, tq)
    assert y.shape == (2, 12, 48)
    y.sum().backward()  # differentiable in x, as the reference's zero bypass
    want = torch.ones(2, 12, 48) @ ql.ref.dequantize_f32(tq.data, tq.scales, "nf4", 32).T
    close(tx.grad, want.numpy(), 1e-5)


def test_fused_linear_q_checks_reject_bad_inputs():
    (x, idx, val, b), _, tq = packed_inputs(np.random.default_rng(34), "nf4", jnp.float32)
    x, idx, val, b = map(torch.from_numpy, (x, idx, val, b))
    ql._check(x, tq.data, tq.scales, idx, val, b, "nf4", 32)
    ql._check(x, tq.data, tq.scales, None, None, None, "nf4", 32)
    bad = [
        ((x[:, :-2], tq.data, tq.scales, idx, val, b, "nf4", 32), ValueError),  # K
        ((x, tq.data, tq.scales, idx, val, b, "nf4", 16), ValueError),  # scale rows
        ((x, tq.data, tq.scales, idx, val, b, "nf4", 3), ValueError),  # odd block
        ((x, tq.data, tq.scales, idx, None, b, "nf4", 32), ValueError),  # idx alone
        ((x, tq.data, tq.scales, idx, val, b, "int8", 32), ValueError),  # rows for int8
        ((x, tq.data.view(torch.int8), tq.scales, idx, val, b, "nf4", 32), TypeError),
        ((x, tq.data, tq.scales, idx.long(), val, b, "nf4", 32), TypeError),
        ((x, tq.data, tq.scales, idx, val, b.bfloat16(), "nf4", 32), TypeError),
        ((x, tq.data, tq.scales, idx, val, b, "int4", 32), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            ql._check(*args)


# ------------------------------------------------- wrappers and counters


def test_cpu_tensors_take_the_plain_version_and_count_it():
    x, idx, val, aid = map(torch.from_numpy, delta_inputs(np.random.default_rng(3)))
    reset_counters()
    sd.sparse_delta_batched(x, idx, val, aid)
    sd.sparse_delta_batched(x, idx, val, aid)
    assert (COUNTERS["sparse_delta_batched"].plain,
            COUNTERS["sparse_delta_batched"].kernel) == (2, 0)
    assert COUNTERS["paged_decode_attention"].plain == 0
    x, w, idx, val, b = map(torch.from_numpy, linear_inputs(np.random.default_rng(24)))
    fl.fused_linear(x, w, idx, val, b)
    sd.sparse_delta_dval(x, idx, torch.ones(24, 48))
    assert (COUNTERS["fused_linear"].plain, COUNTERS["sparse_delta_dval"].plain) == (1, 1)
    attention = {name for names in ATTENTION.values() for name in names}
    assert set(COUNTERS) == (set(SERVING) | attention | set(TRAINING) | set(SINGLE_TENANT)
                             | set(PACKED_BASE) | set(LONG_CONTEXT) | set(SELECTION)
                             | set(TENSOR_PARALLEL))
    reset_counters()
    assert all(c.plain == c.kernel == 0 for c in COUNTERS.values())


@pytest.mark.parametrize("case", ["rank", "dtype", "index_dtype", "aid_shape"])
def test_sparse_delta_checks_reject_bad_inputs(case):
    x, idx, val, aid = map(torch.from_numpy, delta_inputs(np.random.default_rng(4)))
    bad = {
        "rank": ((x[None], idx, val, aid), ValueError),
        "dtype": ((x.double(), idx, val, aid), TypeError),
        "index_dtype": ((x, idx.long(), val, aid), TypeError),
        "aid_shape": ((x, idx, val, aid[:-1]), ValueError),
    }
    args, err = bad[case]
    with pytest.raises(err):
        sd._check(*args)


def test_attention_checks_reject_bad_inputs():
    _, (tq, tk, tv, tt, to, tvl) = paged_inputs(np.random.default_rng(5), 2, 3, jnp.float32)
    with pytest.raises(ValueError):
        dec._check(tq, tk, tv, tt, tvl)  # a chunk of 3 is not one decode token
    with pytest.raises(TypeError):
        pre._check(tq, tk.double(), tv, tt, to, tvl)
    with pytest.raises(TypeError):
        pre._check(tq, tk, tv, tt.long(), to, tvl)
    with pytest.raises(ValueError):
        pre._check(tq, tk, tv, tt[:2], to, tvl)
    pre._check(tq, tk, tv, tt, to, tvl)
    dec._check(tq[:, :1].contiguous(), tk, tv, tt, tvl)


def test_build_is_keyed_on_the_sources_and_needs_nvcc():
    h = build.source_hash()
    assert h == build.source_hash() and len(h) == 16
    assert {p.suffix for p in build.CSRC.iterdir()} <= {".cu", ".cuh"}
    if shutil.which("nvcc") or (build.Path("/usr/local/cuda/bin/nvcc")).exists():
        pytest.skip("this machine has nvcc; the build itself runs on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda, dtype):
    rng = np.random.default_rng(60)
    tol = TOL[dtype]
    x, idx, val, aid = delta_inputs(rng, m=40, d_in=300, d_out=200)
    args = [to_tensor(np.asarray(jnp.asarray(a, dtype))) if a.dtype == np.float32
            else torch.from_numpy(a) for a in (x, idx, val, aid)]
    args = [a.to(cuda) for a in args]
    reset_counters()
    got = sd.sparse_delta_batched(*args)
    close(got.cpu(), sd.sparse_delta_batched_plain(*args).cpu(), tol)
    for g in (1, 2, 4):
        _, (tq, tk, tv, tt, to, tvl) = paged_inputs(rng, g, 6, dtype, hd=128, page=16)
        tq, tk, tv, tt, to, tvl = (t.to(cuda) for t in (tq, tk, tv, tt, to, tvl))
        close(pre.paged_prefill_attention(tq, tk, tv, tt, to, tvl).cpu(),
              pre.paged_prefill_attention_plain(tq, tk, tv, tt, to, tvl).cpu(), tol)
        q1 = tq[:, :1].contiguous()
        close(dec.paged_decode_attention(q1, tk, tv, tt, tvl).cpu(),
              dec.paged_decode_attention_plain(q1, tk, tv, tt, tvl).cpu(), tol)
    torch.cuda.synchronize()
    assert all(COUNTERS[name].kernel > 0 for name in SERVING)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cuda_training_kernels_match_plain_versions(cuda, dtype):
    """Both training kernels on ragged shapes (row, column and K tails, K
    not a multiple of 8 for the unaligned load path)."""
    rng = np.random.default_rng(61)
    tol = TOL[dtype]
    reset_counters()
    for m, kd, n, k in ((200, 1000, 264, 2), (130, 77, 129, 1), (7, 4500, 520, 3)):
        x, w, idx, val, b = linear_inputs(rng, m, kd, n, k)
        dy = (rng.normal(size=(m, n)) * m**-0.5).astype(np.float32)  # dval stays O(1)
        tx, tw, tb, tdy = (both(a, dtype)[1].to(cuda) for a in (x, w, b, dy))
        tidx = torch.from_numpy(idx).to(cuda)
        for tv in (both(val, jnp.bfloat16)[1].to(cuda), both(val, jnp.float32)[1].to(cuda)):
            for bias in (tb, None):
                close(fl.fused_linear(tx, tw, tidx, tv, bias).cpu(),
                      fl.fused_linear_plain(tx, tw, tidx, tv, bias).cpu(), tol)
        got = sd.sparse_delta_dval(tx, tidx, tdy)
        close(got.cpu(), sd.sparse_delta_dval_plain(tx, tidx, tdy).cpu(), tol)
        assert torch.equal(got, sd.sparse_delta_dval(tx, tidx, tdy))  # no atomics
    torch.cuda.synchronize()
    assert all(COUNTERS[name].kernel > 0 for name in TRAINING)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_cuda_fused_linear_q_matches_plain_version(cuda, qdtype, dtype):
    """The packed-base kernel on ragged shapes (row, column and K tails,
    scale blocks crossing tiles, k 0-3)."""
    rng = np.random.default_rng(62)
    tol = TOL[dtype]
    reset_counters()
    for m, kd, n, k, block in ((130, 78, 129, 2, 32), (7, 4500, 520, 3, 128),
                               (200, 1000, 264, 0, 6), (33, 96, 48, 1, 2)):
        (x, idx, val, b), _, tq = packed_inputs(rng, qdtype, dtype, block, m, kd, n, max(k, 1))
        tq = tq.to(cuda)
        tx, tb = (both(a, dtype)[1].to(cuda) for a in (x, b))
        tidx, tv = torch.from_numpy(idx).to(cuda), both(val, jnp.bfloat16)[1].to(cuda)
        if k == 0:
            tidx = tv = None
        args = (tx, tq.data, tq.scales, tidx, tv, tb)
        close(ql.fused_linear_q(*args, qdtype=qdtype, block=block).cpu(),
              ql.fused_linear_q_plain(*args, qdtype=qdtype, block=block).cpu(), tol)
    torch.cuda.synchronize()
    assert COUNTERS["fused_linear_q"].kernel == 4


def test_jax_stays_on_cpu():
    assert jax.devices()[0].platform == "cpu"
