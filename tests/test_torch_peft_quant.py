"""QLoRA and BitFit on a packed (int8 / NF4) base in the port against
``repro.peft`` on the CPU: the comparison of ``test_torch_peft.py`` (its
module docstring states the bounds) on reduced qwen2-1.5b in fp32 packed
with scale blocks of 32. LoRA's base products run the fused dequant
kernel's plain version at zero bypass, differentiable in x; BitFit trains
the biases and norms beside the packed matrices (the reference's ``stats``
fails on that tree, so only the port's is checked: the packed leaves count
as frozen)."""

import pytest

from test_torch_peft import check_method, world  # noqa: F401  (world: the fixture)
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.peft import quantize_base, stats
from repro_torch.quant import QuantizedTensor
from repro_torch.tree import flatten


@pytest.mark.parametrize("method,base", [("lora", "int8"), ("lora", "nf4"), ("bitfit", "int8")])
def test_method_on_a_packed_base_matches_reference(world, method, base):
    reset_counters()
    check_method(world, method, "magnitude", base)
    # every base product through the packed linear's plain version (k = 0)
    assert COUNTERS["fused_linear_q"].plain > 0 and COUNTERS["fused_linear"].plain == 0


def test_bitfit_stats_on_a_packed_base(world):
    from repro_torch.configs import PeftConfig
    from repro_torch.peft import get_peft

    tp = quantize_base(world["tp"], "nf4", block=32)
    trainable, _ = get_peft(PeftConfig(method="bitfit")).init(tp)
    dense, _ = get_peft(PeftConfig(method="bitfit")).init(world["tp"])
    assert stats(tp, trainable)["trainable"] == stats(world["tp"], dense)["trainable"]
    assert all(t is None for (_, t), (_, w) in zip(flatten(trainable), flatten(tp))
               if isinstance(w, QuantizedTensor))
