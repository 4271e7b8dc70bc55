"""The port's quickstart twin on an int8 base against the reference's
(``--base-dtype int8``), on the CPU: the comparison of
``test_torch_examples_quickstart.py``, each package packing the same dense
params with its own ``quantize_base``."""

from test_torch_examples_quickstart import check_twin, world  # noqa: F401


def test_quickstart_twin_on_int8_base_matches_reference(world):  # noqa: F811
    check_twin(world, "int8")
