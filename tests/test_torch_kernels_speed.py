"""The decode-row ``fused_linear_q`` kernel and the tensor-core paged
prefill: what the CPU can hold of them.

``quant_linear.skinny_split`` (the split-K plan of the decode-row kernel)
is pure Python: every K row in exactly one chunk, chunks starting at even
rows, a tile's chunks within one cluster, one wave of blocks and the split
at one of its limits, over qwen2-1.5b's seven projections. ``quant_linear.route`` sends bf16 decode rows to that kernel
(more rows: see ``test_torch_linear.py``).

The plain versions the card's kernels are held to: ``fused_linear_q`` at
the decode rows (M 1, 8 and 16, no bypass and k = 2, int8 and NF4) against
the reference's jnp path and its Pallas kernel in interpret mode, and the
paged prefill (fp and int8 pools) on one whole mixed step (decode, stalled,
idle, full- and part-chunk slots, offsets off the page, GQA groups 1 and
6) against the reference's jnp oracle and its Pallas kernel in interpret
mode, every row compared, pad rows included. Inputs are made with numpy
and fed to both packages. The ``gpu`` tests hold the CUDA kernels against
the plain versions and skip without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.prefill_attention import paged_prefill_attention_pallas
from repro.kernels.quant_linear import fused_linear_q_pallas
from repro.quant import quantize as j_quantize
from repro_torch.convert import to_tensor
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.kernels import prefill_attention as pre
from repro_torch.kernels import quant_linear as ql
from repro_torch.quant import QuantizedTensor

torch.set_num_threads(2)
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}
H100_SMS = 132
QWEN2 = {"wq": (1536, 1536), "wk": (1536, 256), "wv": (1536, 256), "wo": (1536, 1536),
         "wgate": (1536, 8960), "wup": (1536, 8960), "wdown": (8960, 1536)}


def both(arr, dtype):
    """The same values as a JAX array and a torch tensor (same bits)."""
    j = jnp.asarray(arr, dtype)
    return j, to_tensor(np.asarray(j))


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------- the split-K plan


def plan_holds(n, k, sms=H100_SMS):
    n_tile, k_chunk, n_split = ql.skinny_split(n, k, sms)
    assert n_tile == ql.SKINNY_COLS
    starts = [i * k_chunk for i in range(n_split)]
    rows = np.zeros(k, np.int64)
    for s in starts:
        rows[s:min(k, s + k_chunk)] += 1
    assert (rows == 1).all(), "every K row in exactly one chunk"
    assert k_chunk % ql.SKINNY_STEP == 0 and all(s % 2 == 0 for s in starts)
    assert 1 <= n_split <= ql.SKINNY_MAX_SPLIT, "a tile's chunks fit one cluster"
    tiles = -(-n // n_tile)
    blocks = tiles * n_split
    resident = ql.SKINNY_BLOCKS_PER_SM * sms
    assert blocks <= max(resident, tiles), "one wave of blocks"
    # as many chunks as fit: chunks one step shorter would overflow the wave
    # or a cluster, or leave a warp without a 16-row step
    steps = -(-k // ql.SKINNY_STEP)
    shorter = k_chunk - ql.SKINNY_STEP
    more = -(-k // shorter) if shorter else None
    at_limit = (more is None or tiles * more > resident or more > ql.SKINNY_MAX_SPLIT
                or more > max(1, steps // ql.SKINNY_WARPS))
    assert at_limit, (blocks, n_split, k_chunk)
    return blocks, n_split


@pytest.mark.parametrize("proj", list(QWEN2))
def test_skinny_split_covers_k_once_and_fills_the_card(proj):
    k, n = QWEN2[proj]
    plan_holds(n, k)


@pytest.mark.parametrize("n,k", [
    (520, 4500),   # K off every chunk multiple
    (129, 4500),
    (48, 78),      # fewer steps than warps: one chunk
    (8960, 8960),
])
def test_skinny_split_on_ragged_shapes(n, k):
    plan_holds(n, k)


def test_skinny_split_fills_the_card_where_k_allows():
    # wgate / wup / wdown at the decode rows: more than one block an SM
    for proj in ("wgate", "wup", "wdown"):
        k, n = QWEN2[proj]
        blocks, n_split = plan_holds(n, k)
        assert blocks > H100_SMS and n_split > 1, (proj, blocks)
    # wk's 0.4 MB: 12 chunks of 128 rows, one step a warp, 24 blocks
    k, n = QWEN2["wk"]
    assert ql.skinny_split(n, k, H100_SMS) == (128, 128, 12)


def test_route_sends_bf16_decode_rows_to_the_split_k_kernel():
    k, n = QWEN2["wdown"]
    assert [ql.route(m, k, n, torch.bfloat16) for m in (1, 8, ql.SKINNY_ROWS)] == ["skinny"] * 3
    # past the decode rows: the TMA + wgmma kernel where TMA can describe the
    # operands, the tiled WMMA kernel otherwise (K = 78 is no multiple of 8)
    assert ql.route(ql.SKINNY_ROWS + 1, k, n, torch.bfloat16) == "wgmma"
    assert ql.route(2048, k, n, torch.bfloat16) == "wgmma"
    assert ql.route(2048, 78, n, torch.bfloat16) == "tiled"
    assert ql.route(8, k, n, torch.float32) == "f32"


# ------------------------------------- fused_linear_q at the decode rows


def packed_case(rng, m, qdtype, dtype, k, kd=64, n=48, block=32):
    x = rng.normal(size=(m, kd)).astype(np.float32)
    w = (rng.normal(size=(kd, n)) * kd**-0.5).astype(np.float32)
    idx = rng.integers(0, kd, size=(max(k, 1), n)).astype(np.int32)
    val = (rng.normal(size=(max(k, 1), n)) * 0.1).astype(np.float32)
    if k == 0:
        val[:] = 0.0  # the reference's zero bypass is the port's k = 0
    jq = j_quantize(jnp.asarray(w, dtype), qdtype, block)
    tq = QuantizedTensor(to_tensor(np.asarray(jq.data)), to_tensor(np.asarray(jq.scales)),
                         qdtype, block, jq.dtype_name)
    return x, idx, val, jq, tq


def rel_err(got, want) -> float:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_decode_rows_plain_matches_reference(qdtype, m, k):
    """The rows the split-K kernel is held to on the card: fp32 against the
    reference's jnp path (1e-5), bf16 against its Pallas kernel in
    interpret mode (the reference kernel test's 1e-2 relative bound)."""
    rng = np.random.default_rng(70 + m + k)
    x, idx, val, jq, tq = packed_case(rng, m, qdtype, jnp.float32, k)
    tidx, tval = (torch.from_numpy(idx), torch.from_numpy(val)) if k else (None, None)
    want = jops.fused_linear_q(jnp.asarray(x), jq, jnp.asarray(idx), jnp.asarray(val))
    got = ql.fused_linear_q(torch.from_numpy(x), tq.data, tq.scales, tidx, tval,
                            qdtype=qdtype, block=32)
    assert got.shape == (m, 48)
    close(got, want, 1e-5)

    x, idx, val, jq, tq = packed_case(rng, m, qdtype, jnp.bfloat16, k)
    (jx, tx), (jv, tv) = both(x, jnp.bfloat16), both(val, jnp.bfloat16)
    want = fused_linear_q_pallas(jx, jq.data, jq.scales, jnp.asarray(idx), jv, qdtype=qdtype,
                                 block=32, interpret=True)
    got = ql.fused_linear_q(tx, tq.data, tq.scales, torch.from_numpy(idx) if k else None,
                            tv if k else None, qdtype=qdtype, block=32)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) <= 1e-2


# ------------------------------------------- paged prefill, one mixed step

# (q_offset, q_len) a slot: decode, full chunk from 0, full chunk off the
# page, idle, stalled (q_len 0, frontier 9), part chunk (pad rows 3..7),
# decode at the cache's end, part chunk off the page
MIXED = ((13, 1), (0, 8), (5, 8), (0, 0), (9, 0), (22, 3), (30, 1), (7, 5))
PAGE, N_PAGES, C, HD, HKV = 4, 8, 8, 16, 2


def mixed_step(rng, g, dtype, quant):
    b, nblk = len(MIXED), 40
    q_off = np.array([o for o, _ in MIXED], np.int32)
    vl = q_off + np.array([n for _, n in MIXED], np.int32)
    table = np.full((b, N_PAGES), nblk, np.int32)
    perm = list(rng.permutation(nblk))
    for s in range(b):
        used = -(-int(vl[s]) // PAGE)
        table[s, :used] = [perm.pop() for _ in range(used)]
    table[2, :2] = table[1, :2]  # two slots share their leading pages
    q = rng.normal(size=(b, C, g * HKV, HD))
    jq, tq = both(q, dtype)
    ints = [(jnp.asarray(a), torch.from_numpy(a)) for a in (table, q_off, vl)]
    if quant:
        codes = [rng.integers(-127, 128, size=(nblk, PAGE, HKV, HD)).astype(np.int8)
                 for _ in range(2)]
        scales = [(rng.random(size=(nblk, HKV)) * 0.02).astype(np.float32) for _ in range(2)]
        scales[0][table[5, 1]] = 0.0  # an all-zero page
        pools = [(jnp.asarray(c), torch.from_numpy(c)) for c in codes]
        sc = [(jnp.asarray(s), torch.from_numpy(s)) for s in scales]
    else:
        pools = [both(rng.normal(size=(nblk, PAGE, HKV, HD)), dtype) for _ in range(2)]
        sc = []
    j = [jq, pools[0][0], pools[1][0], *[a for a, _ in ints]]
    t = [tq, pools[0][1], pools[1][1], *[a for _, a in ints]]
    return j, t, [a for a, _ in sc], [a for _, a in sc], vl


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("g", [1, 6])
def test_mixed_step_prefill_plain_matches_jnp_oracle(g, quant):
    j, t, js, ts, vl = mixed_step(np.random.default_rng(80 + g), g, jnp.float32, quant)
    if quant:
        want = jref.paged_prefill_attention_q_ref(j[0], j[1], j[2], *js, *j[3:])
    else:
        want = jref.paged_prefill_attention_ref(*j)
    got = pre.paged_prefill_attention(*t, *ts)
    close(got, want, 2e-5)  # every row: real, pad and stalled
    for s, (off, n) in enumerate(MIXED):
        if vl[s] == 0:
            assert not got[s].any(), "an idle slot gets zeros"
        elif n < C:  # pad rows see the slot's whole frontier: defined, not zero
            assert got[s, n:].abs().amax() > 0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("g", [1, 6])
def test_mixed_step_prefill_plain_matches_pallas_interpret(g, quant, dtype):
    j, t, js, ts, _ = mixed_step(np.random.default_rng(90 + g), g, dtype, quant)
    kw = dict(k_scale=js[0], v_scale=js[1]) if quant else {}
    want = paged_prefill_attention_pallas(*j, interpret=True, **kw)
    reset_counters()
    got = pre.paged_prefill_attention(*t, *ts)
    name = "paged_prefill_attention_q" if quant else "paged_prefill_attention"
    assert COUNTERS[name].plain == 1
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    close(got, want, TOL[dtype])


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["int8", "nf4"])
def test_cuda_decode_rows_match_plain_and_repeat_bit_for_bit(cuda, qdtype):
    rng = np.random.default_rng(100)
    reset_counters()
    for m, kd, n, k, block in ((1, 78, 48, 0, 2), (3, 4500, 129, 3, 6),
                               (8, 8960, 256, 1, 64), (16, 4500, 520, 2, 128)):
        x = rng.normal(size=(m, kd)).astype(np.float32)
        w = (rng.normal(size=(kd, n)) * kd**-0.5).astype(np.float32)
        jq = j_quantize(jnp.asarray(w, jnp.bfloat16), qdtype, block)
        data, scales = (to_tensor(np.asarray(a)).to(cuda) for a in (jq.data, jq.scales))
        tx = both(x, jnp.bfloat16)[1].to(cuda)
        idx = val = None
        if k:
            idx = torch.from_numpy(rng.integers(0, kd, size=(k, n)).astype(np.int32)).to(cuda)
            val = torch.from_numpy((rng.normal(size=(k, n)) * 0.05).astype(np.float32)).to(cuda)
        bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).bfloat16().to(cuda)
        args = (tx, data, scales, idx, val, bias)
        got = ql.fused_linear_q(*args, qdtype=qdtype, block=block)
        assert torch.equal(got, ql.fused_linear_q(*args, qdtype=qdtype, block=block))
        close(got.cpu(), ql.fused_linear_q_plain(*args, qdtype=qdtype, block=block).cpu(),
              TOL[jnp.bfloat16])
    torch.cuda.synchronize()
    assert COUNTERS["fused_linear_q"].routes == {"skinny": 8}


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("g", [1, 6])
def test_cuda_prefill_within_three_roundings_of_exact(cuda, g, quant):
    """The tensor-core prefill on the mixed step at hd 16 (page 4, shared
    and sentinel pages, stalled and idle slots): bf16 within 2e-2 of the
    plain version, and as a whole within 3 bf16 roundings of the plain
    version in float32."""
    _, t, _, ts, _ = mixed_step(np.random.default_rng(110 + g), g, jnp.bfloat16, quant)
    t = [a.to(cuda) for a in t]
    ts = [a.to(cuda) for a in ts]
    got = pre.paged_prefill_attention(*t, *ts)
    close(got.cpu(), pre.paged_prefill_attention_plain(*t, *ts).cpu(), TOL[jnp.bfloat16])
    pools = t[1:3] if quant else [p.float() for p in t[1:3]]
    exact = pre.paged_prefill_attention_plain(t[0].float(), *pools, *t[3:], *ts)
    norm = exact.norm()
    rel = float((got.float() - exact).norm() / norm)
    rounding = float((exact.bfloat16().float() - exact).norm() / norm)
    assert rel <= 3 * rounding, (rel, rounding)
