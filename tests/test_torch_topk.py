"""Magnitude selection (NeuroAda phase 1) of the port against the JAX
reference, on the CPU.

* the plain version (``ref.topk_select_ref``) against the Pallas kernel in
  interpret mode on shapes it tiles, as sets (the kernel's order within a
  column is unspecified), and against the reference's jnp oracle and
  ``repro.core.selection.topk_indices`` exactly: the same indices in the
  same order (descending |w|, ties to the lower row), tie-heavy matrices
  and (L, E, d_in, d_out) stacks included, in float32 and bf16;
* the dispatch: one call a stack, the wrapper's checks.

The kernel itself runs on the card only: the ``gpu`` tests hold it, and
the selection dispatch on a CUDA stack, against the CPU result there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.kernels import ref as jref
from repro.kernels.topk_select import topk_select_pallas
from repro_torch.core import selection as tsel
from repro_torch.core.adapt import init_adapters
from repro_torch.kernels import COUNTERS, SELECTION, ops, ref, reset_counters
from repro_torch.kernels import topk_select as ts

torch.set_num_threads(2)


def weights(rng, shape, kind, dtype):
    """(jax array, torch tensor) of the same values: normal, or small
    integers (ties everywhere); in ``dtype``."""
    w = (rng.standard_normal(shape) if kind == "normal"
         else rng.integers(-3, 4, size=shape)).astype(np.float32)
    j = jnp.asarray(w, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("d_in,d_out,k", [(256, 128, 3), (2048, 256, 1), (1024, 384, 8)])
def test_plain_version_matches_pallas_kernel_interpret_as_sets(d_in, d_out, k):
    rng = np.random.default_rng(d_in + k)
    jw, tw = weights(rng, (d_in, d_out), "normal", "float32")
    want = np.asarray(topk_select_pallas(jw, k, interpret=True))
    got = ref.topk_select_ref(tw, k).numpy()
    assert got.shape == want.shape == (k, d_out)
    np.testing.assert_array_equal(np.sort(got, axis=0), np.sort(want, axis=0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("shape,k", [((100, 7), 1), ((100, 7), 2), ((37, 130), 7),
                                     ((64, 9), 64), ((2, 3, 48, 40), 5)])
def test_selection_matches_reference_exactly(shape, k, kind, dtype):
    """Indices and order equal to ``repro.core.selection.topk_indices``
    (``lax.top_k``), for a matrix and an (L, E, d_in, d_out) stack; for a
    single matrix also to the reference kernels' jnp oracle."""
    rng = np.random.default_rng(len(shape) * 100 + k)
    jw, tw = weights(rng, shape, kind, dtype)
    want = np.asarray(jsel.topk_indices(jw, k, strategy="magnitude"))
    reset_counters()
    got = tsel.topk_indices(tw, k)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (COUNTERS["topk_select"].plain, COUNTERS["topk_select"].kernel) == (1, 0)
    if len(shape) == 2:
        np.testing.assert_array_equal(got.numpy(), np.asarray(jref.topk_select_ref(jw, k)))


def test_ops_folds_the_leading_axes_into_one_call():
    w = torch.randn(2, 3, 20, 6)
    reset_counters()
    got = ops.topk_select(w, 4)
    assert got.shape == (2, 3, 4, 6) and COUNTERS["topk_select"].plain == 1
    for i in range(2):
        for e in range(3):
            assert torch.equal(got[i, e], ref.topk_select_ref(w[i, e], 4))
    assert SELECTION == ("topk_select",)


@pytest.mark.parametrize("case", ["rank", "k_low", "k_high", "dtype", "strided"])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(case):
    w = torch.randn(2, 16, 8)
    bad = {"rank": (w[0], 2), "k_low": (w, 0), "k_high": (w, 17),
           "dtype": (w.double(), 2), "strided": (w.transpose(1, 2), 2)}[case]
    with pytest.raises((ValueError, TypeError)):
        ts._check(*bad)
    ts._check(w, 16)


def test_selection_refuses_k_out_of_range_before_any_launch():
    reset_counters()
    with pytest.raises(ValueError, match="out of range"):
        tsel.topk_indices(torch.randn(4, 8, 3), 9)
    assert COUNTERS["topk_select"].plain == 0


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_topk_kernel_matches_plain_version(cuda, dtype):
    """Ragged shapes, k of 1, 2, 7, 64 and k = d_in, a tie-heavy stack:
    indices and order exactly."""
    g = torch.Generator().manual_seed(3)
    reset_counters()
    n = 0
    for b, d_in, d_out, ks in ((1, 100, 1, (1, 2, 7, 64, 100)), (3, 1536, 127, (1, 7)),
                               (2, 96, 300, (2, 64, 96))):
        for kind in ("normal", "ties"):
            w = (torch.randn(b, d_in, d_out, generator=g) if kind == "normal"
                 else torch.randint(-3, 4, (b, d_in, d_out), generator=g).float())
            w = w.to(dtype).to(cuda)
            for k in ks:
                assert torch.equal(ts.topk_select(w, k).cpu(), ts.topk_select_plain(w, k).cpu())
                n += 1
    torch.cuda.synchronize()
    assert COUNTERS["topk_select"].kernel == n


@pytest.mark.gpu
def test_cuda_selection_matches_the_cpu(cuda):
    """``init_adapters`` on a card-resident tree selects the CPU's bytes,
    one launch a stack."""
    g = torch.Generator().manual_seed(4)
    params = {"blocks": {"wq": {"w": torch.randn(3, 64, 96, generator=g).to(torch.bfloat16)},
                         "wup": {"w": torch.randn(3, 64, 200, generator=g).to(torch.bfloat16)}}}
    want, _ = init_adapters(params, 2)
    reset_counters()
    got, _ = init_adapters({"blocks": {n: {"w": p["w"].to(cuda)}
                                       for n, p in params["blocks"].items()}}, 2)
    assert COUNTERS["topk_select"].kernel == 2 and COUNTERS["topk_select"].plain == 0
    for name in ("wq", "wup"):
        assert torch.equal(got["blocks"][name]["w"].cpu(), want["blocks"][name]["w"])
