"""Tensor-parallel serving of the VLM: reduced qwen2-vl-2b's greedy tokens
at tp 2 and 4 against the reference's tp = 1 engine.

The engine serves text prompts with plain RoPE, as the reference's does, so
at tp > 1 the VLM is the dense path on its own shapes: q/k/v biases split
with their columns, a tied head read on each rank's vocabulary rows. The
world is reduced qwen2-vl-2b in float32 with ``num_kv_heads=4`` and
``num_heads=8``; settings, spawned ranks and checks are
``test_torch_tp_serve.py``'s: the paged pool, the paged pool with two
tenants, and the dense cache on an int8 base with two tenants.
"""

import pytest

from test_torch_tp_serve import CASES, Grid

VLM = "qwen2-vl-2b"
FILE_CASES = ("paged_plain", "paged_mt", "dense_mt_int8")
VLM_CASES = {name: dict(CASES[name], arch=VLM) for name in FILE_CASES}


@pytest.fixture(scope="module")
def grid():
    return Grid(FILE_CASES, VLM_CASES)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", FILE_CASES)
def test_vlm_tp_tokens_match_reference_tp1(grid, name, tp):
    grid.check(name, tp)
