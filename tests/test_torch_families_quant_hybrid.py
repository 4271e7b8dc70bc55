"""A packed (int8 / NF4) frozen base on zamba2-2.7b (the hybrid family,
reduced to 2 groups of 2 Mamba-2 blocks): the checks of
``test_torch_families_quant.py`` (its docstring states them and their
bounds). Packed here: the two-level ``(g, per, d_in, d_out)`` stacks
(``in_proj``, ``bc_proj``, the biased ``dt_proj``, ``out_proj``), the tied
shared block's seven projections and the untied head."""

import pytest

from test_torch_families_quant import BASES, CHECKS, packed_world


@pytest.fixture(scope="module", params=BASES)
def world(request):
    return packed_world("zamba2-2.7b", request.param)


@pytest.mark.parametrize("check", CHECKS)
def test_packed_base_matches_the_reference(world, check):
    CHECKS[check](world)
