"""Tensor-parallel serving, continued: the speculative drafters (int8
self-draft on the paged pool, ngram on the dense cache), the dense int8
base with two tenants, and the untied head on an int8 base (reduced
qwen3-32b: ``matmul_q_cols_sharded`` and the head's tenant stacks on each
rank's vocabulary slice), each at tp 2 and 4 against the reference's tp = 1
engine. Settings, worlds and helpers are ``test_torch_tp_serve.py``'s.
"""

import pytest

from test_torch_tp_serve import Grid

FILE_CASES = ("paged_spec_int8", "dense_ngram", "dense_mt_int8", "untied_int8")


@pytest.fixture(scope="module")
def grid():
    return Grid(FILE_CASES)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", FILE_CASES)
def test_tp_tokens_match_reference_tp1(grid, name, tp):
    grid.check(name, tp)
