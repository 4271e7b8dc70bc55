"""The BitFit, masked and full rows of the port's ``peft_comparison`` twin
against ``benchmarks.common.train_and_eval``, on the CPU: the comparison of
``test_torch_examples_peft.py``, whose helpers this file imports."""

import pytest

from test_torch_examples_peft import check_row, world  # noqa: F401


@pytest.mark.parametrize("row", [3, 4, 5])
def test_row_matches_reference(world, row, monkeypatch):  # noqa: F811
    check_row(world, row, monkeypatch)
