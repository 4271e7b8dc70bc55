"""Tensor-parallel serving of the MoE family: the port's greedy tokens at
tp 2 and 4, with the experts split over the ranks, against the reference's
tp = 1 engine.

Reduced olmoe-1b-7b in float32 with ``num_kv_heads=4`` and ``num_heads=8``
(so tp 4 keeps whole GQA groups): its 4 experts top-2 split 2 a rank at
tp 2 and 1 at tp 4, each rank routing every token with the replicated
router and adding its partial sums in one all-reduce a layer. The
reference's random params and two tenants are converted leaf by leaf; the
engine settings, prompts, spawned ranks and checks are
``test_torch_tp_serve.py``'s (tokens equal to ``repro.serve.ServeEngine``
at tp = 1, transfers = steps and a drained pool on every rank, a rank's
pool bytes the reference's / tp). This file holds the plain and tenant
cases and the case table; ``test_torch_tp_moe_serve_int8.py`` the int8
base and KV cases, ``test_torch_tp_moe_serve_spec.py`` the drafters and
the launcher.
"""

import pytest

from test_torch_tp_serve import CASES, Grid

MOE = "olmoe-1b-7b"
NAMES = ("paged_plain", "dense_plain", "paged_mt", "paged_int8", "paged_int8_kv",
         "paged_spec_int8", "dense_ngram", "dense_mt_int8")
MOE_CASES = {name: dict(CASES[name], arch=MOE) for name in NAMES}
FILE_CASES = ("paged_plain", "dense_plain", "paged_mt")


@pytest.fixture(scope="module")
def grid():
    return Grid(FILE_CASES, MOE_CASES)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", FILE_CASES)
def test_moe_tp_tokens_match_reference_tp1(grid, name, tp):
    grid.check(name, tp)
