"""The port's int8 KV cache and dense decode attention against the JAX
reference, on the CPU.

Writers: the four quantize-on-write writers (paged chunk and decode, dense
chunk and decode) must give the reference's codes byte for byte and its
scales bit for bit for the same float32 inputs — a chunk spanning three
pages, an idle slot (``q_len = 0``), sentinel and shared write-table
entries (never rewritten), stale rows past the frontier (kept out of the
scale), rows past the dense cache's end, and a replayed chunk sequence over
a fresh cache (the same bits). The fp dense writers must give the
reference's caches exactly. The port's caches carry a trash block (paged)
or trash slot (dense) that the reference does not have; everything else
is compared.

Attention: the plain versions of the int8 paged decode and prefill bodies
and of the dense decode (fp and int8) against the reference's Pallas
kernels in interpret mode, float32 within 1e-5 and bf16 within 2e-2, with
ragged frontiers (0, 1 and the full cache), an fp ``Smax`` that is not a
multiple of the kernel's tile, sentinel table entries and an all-zero page
(scale 0). The CUDA kernels are held against those plain versions by the
``gpu`` tests, which skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    decode_attention_pallas,
    paged_decode_attention_pallas,
)
from repro.kernels.prefill_attention import paged_prefill_attention_pallas
from repro.models import layers as jl
from repro_torch.convert import to_tensor
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import dense_decode_attention as dd
from repro_torch.kernels import prefill_attention as pre
from repro_torch.models import layers as tl

torch.set_num_threads(2)
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}
KV, HD = 2, 8


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def assert_same_bits(got: torch.Tensor, want) -> None:
    """Byte-identical codes, bit-equal float32 scales (NaN-free)."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def stale_pool(rng, lead: tuple, rows: int):
    """A quantized cache full of large stale values (a prior owner's rows)."""
    codes, scales = jl.quant_kv_page(jnp.asarray(100.0 * rng.normal(size=(*lead, rows, KV, HD)),
                                                 jnp.float32))
    return np.asarray(codes), np.asarray(scales)


def with_trash(a: np.ndarray, axis: int = 0) -> torch.Tensor:
    """The port's layout: one more block (or slot) along ``axis``, zeroed."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, 1)
    return t(np.pad(a, pad))


# --------------------------------------------------------------- writers


def test_quant_kv_page_bytes_match_reference():
    rng = np.random.default_rng(0)
    pages = rng.normal(size=(5, 16, KV, HD)).astype(np.float32) * [[[[1.0]]], [[[1e-3]]],
                                                                    [[[37.0]]], [[[0.0]]],
                                                                    [[[0.5]]]]
    pages[4, :, 1] = 0.0  # one kv-head all zero: scale 0, codes 0
    want_c, want_s = jl.quant_kv_page(jnp.asarray(pages))
    got_c, got_s = tl.quant_kv_page(t(pages))
    assert_same_bits(got_c, want_c)
    assert_same_bits(got_s, want_s)
    assert float(got_s[3].abs().max()) == 0.0 and not got_c[3].any()
    np.testing.assert_array_equal(tl.dequant_kv_page(got_c, got_s).numpy(),
                                  np.asarray(jl.dequant_kv_page(want_c, want_s)))


PAGE, NBLK, NPAGES = 4, 16, 6


def paged_chunk_case(rng):
    """Slot 0 writes 10 rows from position 2 (pages 0-2); slot 1 writes
    positions 6-10, its page 1 shared (the sentinel in its write table);
    slot 2 is a stalled prefill (``q_len = 0``)."""
    wtable = np.full((3, NPAGES), NBLK, np.int32)
    wtable[0, :4] = [3, 7, 1, 12]
    wtable[1, :3] = [5, NBLK, 9]
    wtable[2, :2] = [0, 14]
    q_off = np.array([2, 6, 5], np.int32)
    q_len = np.array([10, 5, 0], np.int32)
    new = rng.normal(size=(3, 10, KV, HD)).astype(np.float32)
    return new, wtable, q_off, q_len


def paged_decode_case(rng):
    """Slot 0 mid-page, slot 1 at a page start, slot 2 evicted (sentinel row)."""
    table = np.full((3, NPAGES), NBLK, np.int32)
    table[0, :2] = [3, 7]
    table[1, :4] = [5, 2, 9, 11]
    pos = np.array([5, 12, 0], np.int32)
    return rng.normal(size=(3, 1, KV, HD)).astype(np.float32), table, pos


S, B = 48, 3


def dense_chunk_case(rng):
    """Slot 0 writes rows 3-22 (groups 0-1), slot 1 rows 40-59 of which 48+
    lie past the cache (dropped), slot 2 is idle."""
    q_off = np.array([3, 40, 7], np.int32)
    q_len = np.array([20, 20, 0], np.int32)
    return rng.normal(size=(B, 20, KV, HD)).astype(np.float32), q_off, q_len


def dense_decode_case(rng):
    return rng.normal(size=(B, 1, KV, HD)).astype(np.float32), np.array([0, 17, 47], np.int32)


@pytest.mark.parametrize("writer", ["paged_chunk", "paged_decode", "dense_chunk",
                                    "dense_decode"])
def test_int8_writers_match_reference_bytes(writer):
    rng = np.random.default_rng(1)
    paged = writer.startswith("paged")
    codes, scales = stale_pool(rng, (NBLK,) if paged else (B, S // 16), PAGE if paged else 16)
    if not paged:
        codes = codes.reshape(B, S, KV, HD)
    tc, ts = with_trash(codes), with_trash(scales)
    if writer == "paged_chunk":
        new, wt, qo, ql = paged_chunk_case(rng)
        want = jl.paged_chunk_cache_update_q(jnp.asarray(codes), jnp.asarray(scales),
                                             jnp.asarray(new), jnp.asarray(wt), jnp.asarray(qo),
                                             jnp.asarray(ql))
        tl.paged_chunk_cache_update_q(tc, ts, t(new), t(wt), t(qo), t(ql))
    elif writer == "paged_decode":
        new, tb, pos = paged_decode_case(rng)
        want = jl.paged_cache_update_q(jnp.asarray(codes), jnp.asarray(scales),
                                       jnp.asarray(new), jnp.asarray(tb), jnp.asarray(pos))
        tl.paged_cache_update_q(tc, ts, t(new), t(tb), t(pos))
    elif writer == "dense_chunk":
        new, qo, ql = dense_chunk_case(rng)
        want = jl.chunk_cache_update_q(jnp.asarray(codes), jnp.asarray(scales),
                                       jnp.asarray(new), jnp.asarray(qo), jnp.asarray(ql))
        tl.chunk_cache_update_q(tc, ts, t(new), t(qo), t(ql))
    else:
        new, pos = dense_decode_case(rng)
        want = jl.cache_update_q(jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(new),
                                 jnp.asarray(pos))
        tl.cache_update_q(tc, ts, t(new), t(pos))
    assert_same_bits(tc[:-1], want[0])
    assert_same_bits(ts[:-1], want[1])
    if writer == "paged_chunk":
        # blocks the chunk does not cover keep their exact bytes: the stalled
        # slot's, slot 0's page 3 and every block outside the write tables
        for blk in (0, 14, 12, 2, 4, 6, 8, 10, 11, 13, 15):
            assert_same_bits(tc[blk], codes[blk])
            assert_same_bits(ts[blk], scales[blk])


@pytest.mark.parametrize("writer", ["chunk", "decode"])
def test_fp_dense_writers_match_reference(writer):
    rng = np.random.default_rng(2)
    cache = rng.normal(size=(B, S, KV, HD)).astype(np.float32)
    tc = with_trash(cache)
    if writer == "chunk":
        new, qo, ql = dense_chunk_case(rng)
        want = jl.chunk_cache_update(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(qo),
                                     jnp.asarray(ql))
        tl.chunk_cache_update(tc, t(new), t(qo), t(ql))
    else:
        new, pos = dense_decode_case(rng)
        want = jl.cache_update(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos))
        tl.cache_update(tc, t(new), t(pos))
    assert_same_bits(tc[:-1], want)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_replayed_chunk_sequence_gives_same_bits(layout):
    """Three chunks, the second starting mid-page, over a fresh cache twice:
    the same bits each time, and the reference's."""
    rng = np.random.default_rng(3)
    chunks = [rng.normal(size=(2, 9, KV, HD)).astype(np.float32) for _ in range(3)]
    q_len = np.array([9, 7], np.int32)
    wt = np.full((2, 12), 24, np.int32)
    wt[0, :7], wt[1, :6] = [4, 9, 1, 17, 20, 3, 8], [0, 11, 5, 2, 23, 6]

    def replay_port():
        if layout == "paged":
            codes, scales = torch.zeros(25, PAGE, KV, HD, dtype=torch.int8), torch.zeros(25, KV)
        else:
            codes = torch.zeros(3, 64, KV, HD, dtype=torch.int8)
            scales = torch.zeros(3, 4, KV)
        off = np.array([0, 2], np.int32)
        for ch in chunks:
            if layout == "paged":
                tl.paged_chunk_cache_update_q(codes, scales, t(ch), t(wt), t(off), t(q_len))
            else:
                tl.chunk_cache_update_q(codes, scales, t(ch), t(off), t(q_len))
            off = off + q_len
        return codes[:-1].clone(), scales[:-1].clone()

    def replay_reference():
        if layout == "paged":
            codes, scales = jnp.zeros((24, PAGE, KV, HD), jnp.int8), jnp.zeros((24, KV))
        else:
            codes, scales = jnp.zeros((2, 64, KV, HD), jnp.int8), jnp.zeros((2, 4, KV))
        off = jnp.asarray([0, 2], jnp.int32)
        for ch in chunks:
            if layout == "paged":
                codes, scales = jl.paged_chunk_cache_update_q(codes, scales, jnp.asarray(ch),
                                                              jnp.asarray(wt), off,
                                                              jnp.asarray(q_len))
            else:
                codes, scales = jl.chunk_cache_update_q(codes, scales, jnp.asarray(ch), off,
                                                        jnp.asarray(q_len))
            off = off + jnp.asarray(q_len)
        return codes, scales

    first, second, want = replay_port(), replay_port(), replay_reference()
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, b)
        assert_same_bits(a, w)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_stale_rows_stay_out_of_the_scale(layout):
    """A fresh writer's scale reflects only its own rows, never the huge
    stale values a prior owner left past the frontier."""
    rng = np.random.default_rng(4)
    new = rng.normal(size=(1, 3, KV, HD)).astype(np.float32)
    zero = t(np.zeros(1, np.int32))
    if layout == "paged":
        codes, scales = stale_pool(rng, (2,), PAGE)
        tc, ts = with_trash(codes), with_trash(scales)
        tl.paged_chunk_cache_update_q(tc, ts, t(new), t(np.array([[1, 2]], np.int32)), zero,
                                      t(np.array([3], np.int32)))
        got_s, got_rows = ts[1], tl.dequant_kv_page(tc[1], ts[1])[:3]
    else:
        codes, scales = stale_pool(rng, (1, 2), 16)
        tc, ts = with_trash(codes.reshape(1, 32, KV, HD)), with_trash(scales)
        tl.chunk_cache_update_q(tc, ts, t(new), zero, t(np.array([3], np.int32)))
        got_s, got_rows = ts[0, 0], (tc[0, :3].float() * ts[0, 0][None, :, None])
    assert torch.equal(got_s, t(np.abs(new[0]).max(axis=(0, 2)) / np.float32(127.0)))
    np.testing.assert_allclose(got_rows.numpy(), new[0], atol=0.02)


# ------------------------------------------------------------- attention


def paged_q_inputs(rng, g, c, dtype, b=4, hkv=2, hd=16, page=4, n_pages=6, nblk=14):
    """Ragged frontiers (slot 3 idle), slot 1 sharing slot 0's leading
    pages, sentinel entries past every frontier, an all-zero page; int8
    pools quantized per (block, kv-head) by the reference's helper."""
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
    kp[table[0, 1]] = 0.0  # a page of zeros: scale 0
    kc, ks = jl.quant_kv_page(jnp.asarray(kp, jnp.float32))
    vc, vs = jl.quant_kv_page(jnp.asarray(vp, jnp.float32))
    jq = jnp.asarray(q, dtype)
    jax_args = (jq, kc, vc, ks, vs) + tuple(jnp.asarray(a) for a in (table, q_off, vl))
    torch_args = (to_tensor(np.asarray(jq)),) + tuple(
        t(np.asarray(a)) for a in (kc, vc, ks, vs, table, q_off, vl))
    return jax_args, torch_args


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("g,hkv,hd", [(1, 2, 16), (6, 2, 16), (1, 16, 128)],
                         ids=["1", "6", "olmoe"])
def test_int8_paged_decode_plain_matches_pallas_interpret(g, hkv, hd, dtype):
    """GQA groups 1 and 6, and olmoe-1b-7b's layout (16 query heads on 16
    kv heads, hd 128); frontiers cross pages."""
    (jq, kc, vc, ks, vs, jt, _, jvl), (tq, tkc, tvc, tks, tvs, tt, _, tvl) = paged_q_inputs(
        np.random.default_rng(10 + g), g, 1, dtype, hkv=hkv, hd=hd)
    want = paged_decode_attention_pallas(jq, kc, vc, jt, jvl, k_scale=ks, v_scale=vs,
                                         interpret=True)
    reset_counters()
    got = dec.paged_decode_attention(tq, tkc, tvc, tt, tvl, tks, tvs)
    assert (COUNTERS["paged_decode_attention_q"].plain, COUNTERS["paged_decode_attention"].plain
            ) == (1, 0)
    assert got.dtype == tq.dtype and float(got[3].abs().max()) == 0.0
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("g", [1, 6])
def test_int8_paged_prefill_plain_matches_pallas_interpret(g, dtype):
    (jq, kc, vc, ks, vs, jt, jo, jvl), (tq, tkc, tvc, tks, tvs, tt, to, tvl) = paged_q_inputs(
        np.random.default_rng(20 + g), g, 5, dtype)
    want = paged_prefill_attention_pallas(jq, kc, vc, jt, jo, jvl, k_scale=ks, v_scale=vs,
                                          interpret=True)
    reset_counters()
    got = pre.paged_prefill_attention(tq, tkc, tvc, tt, to, tvl, tks, tvs)
    assert (COUNTERS["paged_prefill_attention_q"].plain,
            COUNTERS["paged_prefill_attention"].plain) == (1, 0)
    close(got, want, TOL[dtype])


def dense_inputs(rng, smax, g, dtype, quant, b=4, hkv=2, hd=16):
    """Frontiers 0, 1, Smax and one in between; int8 caches quantized per
    (slot, 16-row group, kv-head), one group all zero."""
    q = rng.normal(size=(b, 1, g * hkv, hd))
    k = rng.normal(size=(b, smax, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, smax, hkv, hd)).astype(np.float32)
    vl = np.array([0, 1, smax, smax // 2 + 3], np.int32)
    jq = jnp.asarray(q, dtype)
    tq = to_tensor(np.asarray(jq))
    if not quant:
        jk, jv = jnp.asarray(k, dtype), jnp.asarray(v, dtype)
        return ((jq, jk, jv, jnp.asarray(vl), None, None),
                (tq, to_tensor(np.asarray(jk)), to_tensor(np.asarray(jv)), t(vl), None, None))
    k[1, 16:32] = 0.0
    grouped = lambda a: jnp.asarray(a.reshape(b, smax // 16, 16, hkv, hd))  # noqa: E731
    kc, ks = jl.quant_kv_page(grouped(k))
    vc, vs = jl.quant_kv_page(grouped(v))
    kc, vc = kc.reshape(b, smax, hkv, hd), vc.reshape(b, smax, hkv, hd)
    return ((jq, kc, vc, jnp.asarray(vl), ks, vs),
            (tq,) + tuple(t(np.asarray(a)) for a in (kc, vc, vl, ks, vs)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", ["fp_smax40", "fp_smax64", "int8_smax64"])
def test_dense_decode_plain_matches_pallas_interpret(case, dtype):
    """fp Smax 40 is no multiple of the kernel's 16-row tile (the reference
    pads to its block); int8 Smax is whole groups."""
    quant = case.startswith("int8")
    smax = int(case.rsplit("smax", 1)[1])
    (jq, jk, jv, jvl, jks, jvs), (tq, tk, tv, tvl, tks, tvs) = dense_inputs(
        np.random.default_rng(30), smax, 6, dtype, quant)
    want = decode_attention_pallas(jq, jk, jv, jvl, k_scale=jks, v_scale=jvs, block_s=16,
                                   interpret=True)
    reset_counters()
    got = dd.decode_attention(tq, tk, tv, tvl, tks, tvs)
    name = "decode_attention_q" if quant else "decode_attention"
    assert COUNTERS[name].plain == 1 and COUNTERS[name].kernel == 0
    assert float(got[0].abs().max()) == 0.0  # kv_valid_len 0 gives zeros
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("case", ["no_scales", "one_scale", "fp_with_scales", "bad_scale_shape",
                                  "ragged_groups"])
def test_int8_checks_reject_bad_inputs(case):
    rng = np.random.default_rng(40)
    _, (tq, tkc, tvc, tks, tvs, tt, to, tvl) = paged_q_inputs(rng, 2, 1, jnp.float32)
    err = TypeError if case in ("no_scales", "fp_with_scales") else ValueError
    ks, vs, kp, vp = tks, tvs, tkc, tvc
    if case == "no_scales":
        ks = vs = None
    elif case == "one_scale":
        vs = None
    elif case == "fp_with_scales":
        kp, vp = tkc.float(), tvc.float()
    elif case == "bad_scale_shape":
        ks = vs = tks[:-1].contiguous()
    if case == "ragged_groups":
        q = tq[:, :1].contiguous()
        k = torch.zeros(4, 40, 2, 16, dtype=torch.int8)
        with pytest.raises(err):
            dd._check(q, k, k, tvl, torch.zeros(4, 2, 2), torch.zeros(4, 2, 2))
        return
    with pytest.raises(err):
        dec._check(tq, kp, vp, tt, tvl, ks, vs)
    with pytest.raises(err):
        pre._check(tq, kp, vp, tt, to, tvl, ks, vs)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cuda_int8_paged_kernels_match_plain_versions(cuda, dtype):
    reset_counters()
    for g in (1, 6):
        _, args = paged_q_inputs(np.random.default_rng(50 + g), g, 7, dtype, hd=128, page=16)
        tq, tkc, tvc, tks, tvs, tt, to, tvl = (a.to(cuda) for a in args)
        close(pre.paged_prefill_attention(tq, tkc, tvc, tt, to, tvl, tks, tvs).cpu(),
              pre.paged_prefill_attention_plain(tq, tkc, tvc, tt, to, tvl, tks, tvs).cpu(),
              2e-5 if dtype == jnp.float32 else 2e-2)
        q1 = tq[:, :1].contiguous()
        close(dec.paged_decode_attention(q1, tkc, tvc, tt, tvl, tks, tvs).cpu(),
              dec.paged_decode_attention_plain(q1, tkc, tvc, tt, tvl, tks, tvs).cpu(),
              2e-5 if dtype == jnp.float32 else 2e-2)
    torch.cuda.synchronize()
    assert COUNTERS["paged_prefill_attention_q"].kernel == 2
    assert COUNTERS["paged_decode_attention_q"].kernel == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("case", ["fp_smax40", "fp_smax1000", "int8_smax64", "int8_smax1024"])
def test_cuda_dense_decode_matches_plain_version(cuda, case, dtype):
    quant = case.startswith("int8")
    smax = int(case.rsplit("smax", 1)[1])
    _, args = dense_inputs(np.random.default_rng(60), smax, 6, dtype, quant, b=4, hd=128)
    tq, tk, tv, tvl, tks, tvs = (None if a is None else a.to(cuda) for a in args)
    reset_counters()
    got = dd.decode_attention(tq, tk, tv, tvl, tks, tvs)
    torch.cuda.synchronize()
    close(got.cpu(), dd.decode_attention_plain(tq, tk, tv, tvl, tks, tvs).cpu(),
          2e-5 if dtype == jnp.float32 else 2e-2)
    assert COUNTERS["decode_attention_q" if quant else "decode_attention"].kernel == 1
