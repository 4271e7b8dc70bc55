"""The TMA + wgmma mainloop of ``fused_linear`` and ``fused_linear_q``:
what the CPU can hold of it.

``fused_linear.linear_plan`` and both ``route`` functions are pure Python.
The plan is checked over qwen2-1.5b's seven projections and olmoe-1b-7b's
2048² attention projections at M = 2048 rows (a training step of batch 4
x seq 512, or a serving mixed step of 8 slots x 256): every output element
in exactly one tile, tiles a wgmma can take (rows a multiple of 8 up to
256, columns a multiple of 64), and the card filled in at most 1.2 times
the ideal wave count (blocks / resident blocks, unrounded); on ragged
shapes it stays legal. The routes send those path shapes to the new
kernel and K = 77, N = 129, a misaligned pointer and float32 elsewhere.

The plain versions the kernels are held to: ``fused_linear`` and
``fused_linear_q`` (int8 and NF4) at the edge shapes of the new kernel
(rows past a tile, K with a partial last tile, scale blocks crossing K
tiles, NF4 with an odd number of packed rows in the last tile) against the
reference's jnp functions, inputs made with numpy and fed to both
packages. The ``gpu`` tests hold the CUDA kernels against the plain
versions at the path and edge shapes, two calls bit for bit, and skip
without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant import quantize as j_quantize
from repro_torch.convert import to_tensor
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.kernels import fused_linear as fl
from repro_torch.kernels import quant_linear as ql

torch.set_num_threads(2)
TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}
H100_SMS = 132
M_PATH = 2048  # batch 4 x seq 512, or 8 slots x a 256-token chunk
QWEN2 = {"wq": (1536, 1536), "wk": (1536, 256), "wv": (1536, 256), "wo": (1536, 1536),
         "wgate": (1536, 8960), "wup": (1536, 8960), "wdown": (8960, 1536)}
OLMOE = {"attn": (2048, 2048)}
PATH = {**{f"qwen2-{p}": s for p, s in QWEN2.items()},
        **{f"olmoe-{p}": s for p, s in OLMOE.items()}}
# (M, K, N): rows past a tile (130, 200, 2047), N = 256, K = 1000 (a
# partial last K tile), K = 1064 (NF4: 532 packed rows, 20 in the last tile)
EDGE = ((130, 1000, 256), (200, 1000, 264), (2047, 1536, 256), (33, 1064, 272))


def both(arr, dtype):
    """The same values as a JAX array and a torch tensor (same bits)."""
    j = jnp.asarray(arr, dtype)
    return j, to_tensor(np.asarray(j))


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ the tile plan


def plan_holds(m, n, k, sms=H100_SMS):
    cols, rows, col_tiles, row_tiles = fl.linear_plan(m, n, k, sms)
    assert cols == fl.TMA_COLS and cols % 64 == 0, "columns: whole 64-column warpgroup tiles"
    assert rows in fl.TMA_ROWS and rows % 8 == 0 and 8 <= rows <= 256, "a wgmma n side"
    cover = np.zeros((m, n), np.int64)
    for i in range(row_tiles):
        for j in range(col_tiles):
            cover[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols] += 1
    assert (cover == 1).all(), "every output element in exactly one tile"
    assert (row_tiles - 1) * rows < m and (col_tiles - 1) * cols < n, "no empty tile"
    return col_tiles * row_tiles


@pytest.mark.parametrize("proj", list(PATH))
def test_plan_covers_every_element_once_and_fills_the_card(proj):
    k, n = PATH[proj]
    blocks = plan_holds(M_PATH, n, k)
    resident = fl.TMA_BLOCKS_PER_SM * H100_SMS
    ideal = blocks / resident
    assert -(-blocks // resident) <= 1.2 * ideal, (proj, blocks, ideal)


def test_plan_picks_whole_waves_on_the_path():
    # qwen2's N = 1536 projections: 12 x 11 blocks of 192 rows, one wave;
    # N = 256 (wk, wv): 2 x 64 blocks of 32 rows; olmoe's 2048²: 16 x 8 of 256
    assert fl.linear_plan(M_PATH, 1536, 1536, H100_SMS) == (128, 192, 12, 11)
    assert fl.linear_plan(M_PATH, 1536, 8960, H100_SMS) == (128, 192, 12, 11)
    assert fl.linear_plan(M_PATH, 256, 1536, H100_SMS) == (128, 32, 2, 64)
    assert fl.linear_plan(M_PATH, 2048, 2048, H100_SMS) == (128, 256, 16, 8)


@pytest.mark.parametrize("m,n,k", [(1, 8, 8), (7, 520, 4500), (130, 129, 77), (200, 264, 1000),
                                   (2047, 256, 1536), (5000, 48, 64), (17, 8960, 8960)])
def test_plan_stays_legal_on_ragged_shapes(m, n, k):
    plan_holds(m, n, k)


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        fl.linear_plan(0, 128, 64, H100_SMS)


# ----------------------------------------------------------------- routes


@pytest.mark.parametrize("proj", list(PATH))
def test_routes_send_the_path_shapes_to_the_wgmma_kernel(proj):
    k, n = PATH[proj]
    aligned = (0, 256, 1 << 20)
    assert fl.route(M_PATH, k, n, torch.bfloat16, aligned) == "wgmma"
    assert ql.route(M_PATH, k, n, torch.bfloat16, aligned) == "wgmma"


def test_routes_send_other_shapes_elsewhere():
    ok = (0, 4096)
    # K = 77 and N = 129: x's and W's rows are no whole 16 bytes
    assert fl.route(M_PATH, 77, 1536, torch.bfloat16, ok) == "wmma"
    assert fl.route(M_PATH, 1536, 129, torch.bfloat16, ok) == "wmma"
    assert ql.route(M_PATH, 78, 1536, torch.bfloat16, ok) == "tiled"
    # the codes' row stride is N bytes: N = 264 is a multiple of 8, not of 16
    assert fl.route(M_PATH, 1536, 264, torch.bfloat16, ok) == "wgmma"
    assert ql.route(M_PATH, 1536, 264, torch.bfloat16, ok) == "tiled"
    # a pointer 8 bytes off (a row view of an odd row)
    assert fl.route(M_PATH, 1536, 1536, torch.bfloat16, (0, 8)) == "wmma"
    assert ql.route(M_PATH, 1536, 1536, torch.bfloat16, (8, 0, 0)) == "tiled"
    # float32 and the decode rows
    assert fl.route(M_PATH, 1536, 1536, torch.float32, ok) == "f32"
    assert ql.route(M_PATH, 1536, 1536, torch.float32, ok) == "f32"
    assert ql.route(ql.SKINNY_ROWS, 1536, 1536, torch.bfloat16, ok) == "skinny"


# ------------------------------------------- plain versions at the edge shapes


@pytest.mark.parametrize("m,kd,n", EDGE)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_fused_linear_plain_matches_reference_at_edge_shapes(m, kd, n, dtype):
    rng = np.random.default_rng(m + kd + n)
    jx, tx = both(rng.normal(size=(m, kd)), dtype)
    jw, tw = both(rng.normal(size=(kd, n)) * kd**-0.5, dtype)
    jb, tb = both(rng.normal(size=n), dtype)
    idx = rng.integers(0, kd, size=(2, n)).astype(np.int32)
    jv, tv = both(rng.normal(size=(2, n)) * 0.05, jnp.bfloat16)
    want = jref.fused_linear_ref(jx, jw, jnp.asarray(idx), jv, jb)
    got = fl.fused_linear(tx, tw, torch.from_numpy(idx), tv, tb)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("m,kd,n", EDGE)
@pytest.mark.parametrize("qdtype,block", [("int8", 48), ("nf4", 64), ("nf4", 6)])
def test_fused_linear_q_plain_matches_reference_at_edge_shapes(m, kd, n, qdtype, block):
    """float32 against the reference's jnp path (dequantize + dot), 1e-5."""
    rng = np.random.default_rng(7 * m + kd + n)
    w = (rng.normal(size=(kd, n)) * kd**-0.5).astype(np.float32)
    jq = j_quantize(jnp.asarray(w), qdtype, block)
    data, scales = (to_tensor(np.asarray(a)) for a in (jq.data, jq.scales))
    x = rng.normal(size=(m, kd)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    idx = rng.integers(0, kd, size=(1, n)).astype(np.int32)
    val = (rng.normal(size=(1, n)) * 0.05).astype(np.float32)
    want = jops.fused_linear_q(jnp.asarray(x), jq, jnp.asarray(idx), jnp.asarray(val),
                               jnp.asarray(b))
    got = ql.fused_linear_q(torch.from_numpy(x), data, scales, torch.from_numpy(idx),
                            torch.from_numpy(val), torch.from_numpy(b), qdtype=qdtype,
                            block=block)
    close(got, want, TOL[jnp.float32])


# -------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_cases():
    """The path shapes at M = 2048 (k = 1, bias on wq/wk/wv) and the edge
    shapes (k = 2, bias)."""
    for name, (kd, n) in PATH.items():
        yield M_PATH, kd, n, 1, name.split("-")[1] in ("wq", "wk", "wv")
    for m, kd, n in EDGE:
        yield m, kd, n, 2, True


@pytest.mark.gpu
def test_cuda_fused_linear_wgmma_matches_plain_and_repeats_bit_for_bit(cuda):
    rng = np.random.default_rng(200)
    reset_counters()
    launches = 0
    for m, kd, n, k, has_bias in card_cases():
        x = both(rng.normal(size=(m, kd)), jnp.bfloat16)[1].to(cuda)
        w = both(rng.normal(size=(kd, n)) * kd**-0.5, jnp.bfloat16)[1].to(cuda)
        idx = torch.from_numpy(rng.integers(0, kd, size=(k, n)).astype(np.int32)).to(cuda)
        val = both(rng.normal(size=(k, n)) * 0.05, jnp.bfloat16)[1].to(cuda)
        bias = both(rng.normal(size=n), jnp.bfloat16)[1].to(cuda) if has_bias else None
        got = fl.fused_linear(x, w, idx, val, bias)
        assert torch.equal(got, fl.fused_linear(x, w, idx, val, bias)), (m, kd, n)
        launches += 2
        close(got.cpu(), fl.fused_linear_plain(x, w, idx, val, bias).cpu(), TOL[jnp.bfloat16])
    torch.cuda.synchronize()
    assert COUNTERS["fused_linear"].routes == {"wgmma": launches}


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype,block", [("int8", 64), ("nf4", 64), ("int8", 48), ("nf4", 6)])
def test_cuda_fused_linear_q_wgmma_matches_plain_and_repeats_bit_for_bit(cuda, qdtype, block):
    rng = np.random.default_rng(300 + block)
    reset_counters()
    launches = 0
    for m, kd, n, k, has_bias in card_cases():
        w = (rng.normal(size=(kd, n)) * kd**-0.5).astype(np.float32)
        jq = j_quantize(jnp.asarray(w, jnp.bfloat16), qdtype, block)
        data, scales = (to_tensor(np.asarray(a)).to(cuda) for a in (jq.data, jq.scales))
        x = both(rng.normal(size=(m, kd)), jnp.bfloat16)[1].to(cuda)
        idx = torch.from_numpy(rng.integers(0, kd, size=(k, n)).astype(np.int32)).to(cuda)
        val = both(rng.normal(size=(k, n)) * 0.05, jnp.bfloat16)[1].to(cuda)
        bias = both(rng.normal(size=n), jnp.bfloat16)[1].to(cuda) if has_bias else None
        args = (x, data, scales, idx, val, bias)
        got = ql.fused_linear_q(*args, qdtype=qdtype, block=block)
        assert torch.equal(got, ql.fused_linear_q(*args, qdtype=qdtype, block=block))
        expect = ql.route(m, kd, n, torch.bfloat16, (x.data_ptr(), data.data_ptr(),
                                                       scales.data_ptr()))
        launches += 2 * (expect == "wgmma")
        close(got.cpu(), ql.fused_linear_q_plain(*args, qdtype=qdtype, block=block).cpu(),
              TOL[jnp.bfloat16])
    torch.cuda.synchronize()
    assert COUNTERS["fused_linear_q"].routes.get("wgmma", 0) == launches > 0
