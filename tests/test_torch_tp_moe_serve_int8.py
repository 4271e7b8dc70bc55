"""Tensor-parallel serving of the MoE family, continued: an int8 base of
32-row blocks on the paged pool (each rank dequantizes only its own packed
expert stacks; the untied head runs ``matmul_q_cols_sharded`` on its
vocabulary slice), int8 KV on the paged pool, and the dense cache on an
int8 base with two tenants, each at tp 2 and 4 against the reference's
tp = 1 engine. World, settings and helpers are
``test_torch_tp_moe_serve.py``'s.
"""

import pytest

from test_torch_tp_moe_serve import MOE_CASES
from test_torch_tp_serve import Grid

FILE_CASES = ("paged_int8", "paged_int8_kv", "dense_mt_int8")


@pytest.fixture(scope="module")
def grid():
    return Grid(FILE_CASES, MOE_CASES)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", FILE_CASES)
def test_moe_tp_tokens_match_reference_tp1(grid, name, tp):
    grid.check(name, tp)
