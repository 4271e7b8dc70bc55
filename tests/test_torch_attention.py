"""The decode kernel's plan and the flash forward's routes: what the CPU can
hold of the two attention kernels redesigned for Hopper.

``decode_attention.decode_plan`` is pure Python: for every GQA group, head
dim and pool type the kernel takes, its page ranges cover the table width
exactly once, its head chunks cover the group exactly once, its shared
memory fits a block (and holds the kernel's own reckoning of it), and on
the card's 132 SMs the grid has at least one block an SM wherever the
shape has that many (slot, kv-head, head chunk, warp-sized range) pieces.
``flash_attention.route`` sends bf16 at hd 64 / 128 — contiguous or as
strided views of one fused qkv projection — to the TMA + ``wgmma`` kernel,
the other bf16 head dims to the ``mma.sync`` one and float32 to the FMA one.

The plain versions behind the kernels are held to the JAX reference in
``test_torch_kernels.py``, ``test_torch_kv.py`` and ``test_torch_flash.py``
(olmoe's head layout included). The ``gpu`` tests hold the kernels to the
plain versions on the card — frontiers on and around page boundaries, the
table's full width, sentinel entries, int8 pools, a dense Smax that is no
multiple of 16; flash tails, Skv != Sq and fused views — two calls bit for
bit, every launch on its route; they skip without a card.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import dense_decode_attention as dd
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)
H100_SMS = 132
SMEM_MAX = 232448
WIDTHS = (1, 3, 16, 64, 65, 2048)  # table widths in pages (64: qwen2/olmoe at max_len 1024)
LAYOUTS = ((1, 1), (8, 2), (8, 16), (64, 4))  # (slots, kv heads)


def kernel_smem(plan, page, hd, pool_dtype) -> int:
    """The kernel's own reckoning (decode_smem_bytes in paged_attention.cuh):
    the warps' rings, or the warp merge at the heads' register capacity."""
    rs = -(-hd // 16) * 16
    stage = 2 * page * rs * dec.CODE_BYTES[pool_dtype] + 16
    warps = plan.threads // 32
    reg_heads = 1 << (plan.heads - 1).bit_length()
    return max(warps * plan.stages * stage, warps * reg_heads * (rs + 2) * 4)


@pytest.mark.parametrize("pool_dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "f32", "int8"])
@pytest.mark.parametrize("hd", [16, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 6, 8, 16, 32])
def test_decode_plan_covers_every_page_once_and_fits(g, hd, pool_dtype):
    for b, hkv in LAYOUTS:
        for n_pages in WIDTHS:
            for max_heads in (dec.HEADS, 2, 8):
                plan = dec.decode_plan(b, hkv, g, n_pages, H100_SMS, pool_dtype, hd,
                                       max_heads=max_heads)
                what = (b, hkv, g, n_pages, hd, pool_dtype, max_heads, plan)
                # ranges [r * per, (r + 1) * per) partition the table width
                assert plan.per >= 1 and plan.ranges >= 1, what
                assert plan.per * (plan.ranges - 1) < n_pages <= plan.per * plan.ranges, what
                # head chunks partition the group
                assert 1 <= plan.heads <= min(g, max_heads, 8 if hd <= 128 else 4), what
                assert plan.heads * (plan.head_chunks - 1) < g <= plan.heads * plan.head_chunks
                assert plan.threads in (32, 64, 128) and 1 <= plan.stages <= 4, what
                assert kernel_smem(plan, 16, hd, pool_dtype) <= plan.smem <= SMEM_MAX, what
                assert plan.ranges <= 65535, what  # the grid's y axis


@pytest.mark.parametrize("b,hkv,g,n_pages", [(8, 2, 6, 64), (8, 16, 1, 64), (1, 1, 1, 3),
                                             (1, 2, 6, 2048), (64, 4, 8, 16), (3, 1, 16, 7)])
def test_decode_plan_fills_the_card_where_the_shape_allows(b, hkv, g, n_pages):
    """At least one block an SM wherever the (slot, kv-head, head chunk)
    pairs times warp-sized ranges reach 132; qwen2-1.5b's and olmoe-1b-7b's
    serving shapes (the first two) give each warp one page."""
    for pool_dtype in (torch.bfloat16, torch.int8):
        plan = dec.decode_plan(b, hkv, g, n_pages, H100_SMS, pool_dtype, 128)
        warps = plan.threads // 32
        pairs = b * hkv * plan.head_chunks
        blocks = pairs * plan.ranges
        assert blocks >= min(H100_SMS, pairs * -(-n_pages // warps)), plan
        if (b, hkv, n_pages) in ((8, 2, 64), (8, 16, 64)):
            assert (plan.per, plan.threads, plan.stages) == (4, 128, 1), plan


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("fused", [False, True], ids=["contiguous", "fused_qkv"])
def test_flash_route_takes_wgmma_for_bf16_at_hd_64_and_128(hd, fused):
    b, s, h, hkv = 2, 130, 12, 2
    if fused:  # q, k, v as strided views of one (B, S, (H + 2 Hkv) hd) projection
        qkv = torch.zeros(b, s, (h + 2 * hkv) * hd, dtype=torch.bfloat16)
        q, k, v = (qkv[..., a * hd:(a + n) * hd].unflatten(-1, (n, hd))
                   for a, n in ((0, h), (h, hkv), (h + hkv, hkv)))
        assert not q.is_contiguous() and q.stride(1) == (h + 2 * hkv) * hd
    else:
        q = torch.zeros(b, s, h, hd, dtype=torch.bfloat16)
        k = v = torch.zeros(b, s, hkv, hd, dtype=torch.bfloat16)
    assert fa.route(q, k, v) == "wgmma"
    assert fa.route(q.float(), k.float(), v.float()) == "fma"


@pytest.mark.parametrize("hd", [16, 32, 48, 80, 96, 112])
def test_flash_route_takes_mma_at_the_other_bf16_head_dims(hd):
    q = torch.zeros(1, 64, 4, hd, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, hd, dtype=torch.bfloat16)
    assert fa.route(q, k, k) == "mma"
    assert fa.route(q.float(), k.float(), k.float()) == "fma"


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def paged(rng, vl, h, hkv, hd, dtype, dev, page=16, n_pages=64):
    """q (B, 1, H, hd) and pools through a table whose pages past each
    frontier hold the sentinel (the pool's size)."""
    nblk = len(vl) * n_pages
    table = np.full((len(vl), n_pages), nblk, np.int32)
    perm = list(rng.permutation(nblk))
    for s, n in enumerate(vl):
        table[s, :-(-n // page)] = [perm.pop() for _ in range(-(-n // page))]
    t = lambda a, dt=dtype: torch.from_numpy(np.asarray(a)).to(dt).to(dev)  # noqa: E731
    return (t(rng.normal(size=(len(vl), 1, h, hd))), t(rng.normal(size=(nblk, page, hkv, hd))),
            t(rng.normal(size=(nblk, page, hkv, hd))), t(table, torch.int32),
            t(np.asarray(vl), torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_kernel_matches_plain_and_repeats_bit_for_bit(cuda, dtype):
    """Frontiers 0, 1, 15, 16, 17 and the full width (1024), GQA groups 1,
    6 and 16, hd 64-256; paged fp and int8 pools, a dense cache with Smax
    1000; idle slots give zeros, two calls the same bits."""
    rng = np.random.default_rng(7)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    vl = [0, 1, 15, 16, 17, 1024, 300, 33]
    for h, hkv, hd in ((16, 16, 128), (12, 2, 128), (32, 2, 64), (8, 4, 256)):
        q, kp, vp, table, tvl = paged(rng, vl, h, hkv, hd, dtype, cuda)
        kc = torch.randint(-127, 128, kp.shape, dtype=torch.int8, device=cuda)
        vc = torch.randint(-127, 128, kp.shape, dtype=torch.int8, device=cuda)
        ks = torch.rand(kp.shape[0], hkv, device=cuda) / 127
        vs = torch.rand(kp.shape[0], hkv, device=cuda) / 127
        dk = torch.randn(len(vl), 1000, hkv, hd, device=cuda).to(dtype)
        dv = torch.randn(len(vl), 1000, hkv, hd, device=cuda).to(dtype)
        dvl = tvl.clamp(max=1000).contiguous()
        for name, fn, plain, args in (
                ("paged_decode_attention", dec.paged_decode_attention,
                 dec.paged_decode_attention_plain, (q, kp, vp, table, tvl)),
                ("paged_decode_attention_q", dec.paged_decode_attention,
                 dec.paged_decode_attention_plain, (q, kc, vc, table, tvl, ks, vs)),
                ("decode_attention", dd.decode_attention, dd.decode_attention_plain,
                 (q, dk, dv, dvl))):
            reset_counters()
            got = fn(*args)
            torch.testing.assert_close(got.float(), plain(*args).float(), atol=tol, rtol=tol)
            assert torch.equal(got, fn(*args)), (name, h, hkv, hd)
            assert float(got[0].float().abs().max()) == 0.0, "an idle slot gives zeros"
            assert COUNTERS[name].routes == {dec.ROUTE: 2}, COUNTERS[name].routes


@pytest.mark.gpu
def test_cuda_flash_wgmma_matches_plain_and_repeats_bit_for_bit(cuda):
    """Sq and Skv off the 128-row tiles, Skv != Sq (full and causal),
    fused-qkv views, hd 64 and 128: out within 2e-2 and three bf16
    roundings of the float32 plain output, lse within 1e-4."""
    torch.manual_seed(3)
    for b, sq, skv, h, hkv, hd, causal, fused in (
            (1, 200, 200, 4, 2, 64, True, False), (2, 300, 300, 12, 2, 128, True, True),
            (1, 130, 333, 6, 6, 128, False, False), (1, 333, 200, 4, 2, 128, True, False)):
        if fused:
            qkv = torch.randn(b, sq, (h + 2 * hkv) * hd, device=cuda).to(torch.bfloat16)
            q, k, v = (qkv[..., a * hd:(a + n) * hd].unflatten(-1, (n, hd))
                       for a, n in ((0, h), (h, hkv), (h + hkv, hkv)))
        else:
            q = torch.randn(b, sq, h, hd, device=cuda).to(torch.bfloat16)
            k, v = (torch.randn(b, skv, hkv, hd, device=cuda).to(torch.bfloat16)
                    for _ in range(2))
        reset_counters()
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        out2, lse2 = fa.flash_attention_fwd(q, k, v, causal=causal)
        assert torch.equal(out, out2) and torch.equal(lse, lse2)
        assert COUNTERS["flash_attention_fwd"].routes == {"wgmma": 2}
        want, want_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
        exact = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(), causal=causal)[0]
        assert (out.float() - exact).norm() <= 3 * (exact.to(torch.bfloat16).float() - exact).norm()
