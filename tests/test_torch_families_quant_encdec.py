"""A packed (int8 / NF4) frozen base on seamless-m4t-large-v2 (the
encoder-decoder family): the checks of ``test_torch_families_quant.py``
(its docstring states them and their bounds) on the reduced config of
``test_torch_encdec.py``, 24 frames. Packed here: both stacks' 1024 <-> 8192
shaped projections (64 <-> 128 reduced), the cross-attention's, and the
untied head."""

import pytest

from test_torch_families_quant import BASES, CHECKS, packed_world


@pytest.fixture(scope="module", params=BASES)
def world(request):
    return packed_world("seamless-m4t-large-v2", request.param)


@pytest.mark.parametrize("check", CHECKS)
def test_packed_base_matches_the_reference(world, check):
    CHECKS[check](world)
