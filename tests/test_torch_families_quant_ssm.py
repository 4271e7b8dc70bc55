"""A packed (int8 / NF4) frozen base on falcon-mamba-7b (the SSM family):
the checks of ``test_torch_families_quant.py`` (its docstring states them
and their bounds). Packed here: ``in_proj``, ``x_proj``, the biased
``dt_proj`` (d_in = dt rank 8 reduced, one zero-padded scale block),
``out_proj`` and the untied head."""

import pytest

from test_torch_families_quant import BASES, CHECKS, packed_world


@pytest.fixture(scope="module", params=BASES)
def world(request):
    return packed_world("falcon-mamba-7b", request.param)


@pytest.mark.parametrize("check", CHECKS)
def test_packed_base_matches_the_reference(world, check):
    CHECKS[check](world)
