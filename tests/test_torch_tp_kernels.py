"""The four tensor-parallel kernel wrappers against the reference's
unsharded Pallas kernels (interpret mode), rank by rank.

At the shapes of the reference's ``_KERNELS`` check
(``tests/serve/test_sharded.py``: B 2, H 8, KV 4, hd 16, S 32; pools of 8
pages of 8 rows; a chunk of 4; x (4, 32) on a (32, 64) packed head with
16-row blocks), each rank of tp 2 runs the port's wrapper on its local
slices (its q heads, its kv-heads of the cache or pool and of the int8
scales, its columns of the packed head), and its output equals that rank's
slice of the reference's unsharded Pallas output within 1e-4: the fp and
int8 bodies of the three attention kernels, and the int8 and NF4 heads.
The reference's own sharded wrappers equal its unsharded kernels
(``test_sharded_kernel_wrappers_match_replicated``), so the sliced
unsharded output is their output. Also: each wrapper refuses local heads
that are not one rank's share, and counts its calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas, paged_decode_attention_pallas
from repro.kernels.prefill_attention import paged_prefill_attention_pallas
from repro.models import layers as jl
from repro.quant.qtensor import quantize as j_quantize
from repro_torch.convert import to_tensor, tree_to_torch
from repro_torch.kernels import COUNTERS, TENSOR_PARALLEL, reset_counters
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import dense_decode_attention as dd
from repro_torch.kernels import prefill_attention as pre
from repro_torch.kernels import quant_linear as ql

torch.set_num_threads(2)
B, H, KV, HD, S = 2, 8, 4, 16, 32
N, PAGE, C = 8, 8, 4
TP = 2
HEADS = (H, KV)


def f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a))


def quant(pages: np.ndarray):
    """int8 codes and (…, KV) float32 scales of (…, rows, KV, hd) pages, by
    the reference's writer arithmetic."""
    codes, scales = jl.quant_kv_page(jnp.asarray(pages))
    return np.asarray(codes), np.asarray(scales)


def heads(a, rank, axis):
    n = a.shape[axis] // TP
    return np.take(a, range(rank * n, rank * n + n), axis=axis)


def check_ranks(want, run):
    """``run(rank)`` -> the port's local output; held against the rank's
    q-head slice of the reference's output (B, S, H, hd)."""
    want = np.asarray(want)
    for r in range(TP):
        got = run(r)
        np.testing.assert_allclose(got.numpy(), heads(want, r, 2), rtol=1e-4, atol=1e-4,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("body", ["fp", "int8"])
def test_decode_attention_sharded_matches_reference(body):
    rng = np.random.default_rng(0)
    q, k, v = f(rng, B, 1, H, HD), f(rng, B, S, KV, HD), f(rng, B, S, KV, HD)
    vl = np.array([7, 29], np.int32)
    if body == "fp":
        want = decode_attention_pallas(q, k, v, vl, interpret=True)
        check_ranks(want, lambda r: dd.decode_attention_sharded(
            t(heads(q, r, 2)), t(heads(k, r, 2)), t(heads(v, r, 2)), t(vl), TP, HEADS))
        return
    kc, ks = quant(k.reshape(B, S // 16, 16, KV, HD))
    vc, vs = quant(v.reshape(B, S // 16, 16, KV, HD))
    kc, vc = kc.reshape(B, S, KV, HD), vc.reshape(B, S, KV, HD)
    want = decode_attention_pallas(q, kc, vc, vl, k_scale=ks, v_scale=vs, interpret=True)
    check_ranks(want, lambda r: dd.decode_attention_sharded(
        t(heads(q, r, 2)), t(heads(kc, r, 2)), t(heads(vc, r, 2)), t(vl), TP, HEADS,
        t(heads(ks, r, 2)), t(heads(vs, r, 2))))


def pools(rng, body):
    kp, vp = f(rng, N, PAGE, KV, HD), f(rng, N, PAGE, KV, HD)
    table = np.array([[0, 2, 4, 8], [1, 3, 8, 8]], np.int32)
    if body == "fp":
        return table, (kp, vp), {}
    kc, ks = quant(kp)
    vc, vs = quant(vp)
    return table, (kc, vc), {"k_scale": ks, "v_scale": vs}


def local_pools(pl, sc, r):
    """A rank's kv-heads of the pools (axis 2) and of the scales (last)."""
    kl, vl_ = (t(heads(p, r, 2)) for p in pl)
    scales = [t(heads(sc[key], r, 1)) for key in ("k_scale", "v_scale")] if sc else [None, None]
    return kl, vl_, scales


@pytest.mark.parametrize("body", ["fp", "int8"])
def test_paged_decode_attention_sharded_matches_reference(body):
    rng = np.random.default_rng(1)
    q = f(rng, B, 1, H, HD)
    table, pl, sc = pools(rng, body)
    vl = np.array([7, 15], np.int32)  # inside the two allocated pages
    want = paged_decode_attention_pallas(q, *pl, table, vl, interpret=True, **sc)

    def run(r):
        kl, vl_, (ksl, vsl) = local_pools(pl, sc, r)
        return dec.paged_decode_attention_sharded(t(heads(q, r, 2)), kl, vl_, t(table), t(vl),
                                                  TP, HEADS, ksl, vsl)

    check_ranks(want, run)


@pytest.mark.parametrize("body", ["fp", "int8"])
def test_paged_prefill_attention_sharded_matches_reference(body):
    rng = np.random.default_rng(2)
    qc = f(rng, B, C, H, HD)
    table, pl, sc = pools(rng, body)
    qoff = np.array([3, 10], np.int32)
    vl = qoff + C
    want = paged_prefill_attention_pallas(qc, *pl, table, qoff, vl, interpret=True, **sc)

    def run(r):
        kl, vl_, (ksl, vsl) = local_pools(pl, sc, r)
        return pre.paged_prefill_attention_sharded(t(heads(qc, r, 2)), kl, vl_, t(table),
                                                   t(qoff), t(vl), TP, HEADS, ksl, vsl)

    check_ranks(want, run)


@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_matmul_q_cols_sharded_matches_reference(qdtype):
    rng = np.random.default_rng(3)
    x = f(rng, 4, 32)
    jqw = j_quantize(jnp.asarray(f(rng, 32, 64)), qdtype, block=16)
    prev = jops.get_backend()
    jops.set_backend("pallas_interpret")
    try:
        want = np.asarray(jops.matmul_q(jnp.asarray(x), jqw))
    finally:
        jops.set_backend(prev)
    qw = tree_to_torch({"w": jqw})["w"]
    for r in range(TP):
        cols = slice(r * 32, r * 32 + 32)
        got = ql.matmul_q_cols_sharded(t(x), qw.data[:, cols].contiguous(),
                                       qw.scales[:, cols].contiguous(), qdtype=qdtype, block=16)
        np.testing.assert_allclose(got.numpy(), want[:, cols], rtol=1e-4, atol=1e-4,
                                   err_msg=f"rank {r}")


def test_wrappers_refuse_heads_that_are_not_a_ranks_share_and_count_calls():
    rng = np.random.default_rng(4)
    q, k = t(f(rng, B, 1, H // TP, HD)), t(f(rng, B, S, KV // TP, HD))
    vl = t(np.array([3, 9], np.int32))
    reset_counters()
    dd.decode_attention_sharded(q, k, k, vl, TP, HEADS)
    assert COUNTERS["decode_attention_sharded"].plain == 1
    assert COUNTERS["decode_attention"].plain == 1  # the kernel it wraps, counted as ever
    assert set(TENSOR_PARALLEL) <= set(COUNTERS)
    with pytest.raises(ValueError, match="does not divide"):
        dd.decode_attention_sharded(q, k, k, vl, 3, HEADS)
    with pytest.raises(ValueError, match="not one rank's"):
        dd.decode_attention_sharded(q, k, k, vl, TP, (2 * H, KV))  # q holds half a share
    table, (kp, vp), _ = pools(rng, "fp")
    with pytest.raises(ValueError, match="not one rank's"):  # a whole pool under tp 2
        dec.paged_decode_attention_sharded(q, t(kp), t(vp), t(table), vl, TP, HEADS)
    with pytest.raises(ValueError, match="not one rank's"):
        pre.paged_prefill_attention_sharded(q, t(kp), t(vp), t(table), vl, vl, TP, HEADS)
