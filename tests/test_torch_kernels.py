"""Kernel modules of the PyTorch port against the JAX reference.

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
from repro.kernels.prefill_attention import paged_prefill_attention_pallas
from repro.kernels.sparse_delta import sparse_delta_batched_pallas
from repro_torch.convert import to_tensor
from repro_torch.kernels import COUNTERS, build, ops, reset_counters
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import prefill_attention as pre
from repro_torch.kernels import sparse_delta as sd

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


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_plain_matches_pallas_interpret(g, dtype):
    (jq, jk, jv, jt, _, jvl), (tq, tk, tv, tt, _, tvl) = paged_inputs(
        np.random.default_rng(20 + g), g, 1, dtype, b=3)
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


# ------------------------------------------------- wrappers and counters


def test_cpu_tensors_take_the_plain_version_and_count_it():
    x, idx, val, aid = map(torch.from_numpy, delta_inputs(np.random.default_rng(3)))
    reset_counters()
    sd.sparse_delta_batched(x, idx, val, aid)
    sd.sparse_delta_batched(x, idx, val, aid)
    assert (COUNTERS["sparse_delta_batched"].plain,
            COUNTERS["sparse_delta_batched"].kernel) == (2, 0)
    assert COUNTERS["paged_decode_attention"].plain == 0
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
    assert all(c.kernel > 0 for c in COUNTERS.values())


def test_jax_stays_on_cpu():
    assert jax.devices()[0].platform == "cpu"
