"""The plain reference against the program's plain CPU path, in float32 on
tiny configurations of both families: the training loss and the values'
gradients, and the selection."""

import pytest
import torch

from portbench.harness import weights
from portbench.harness.program import model_config
from portbench.reference import model as ref
from portbench.reference import train as ref_train
from portbench.tests.tiny import DENSE, MOE


def _program_adapters(arch, idx, val):
    from repro_torch.core.delta import Delta

    tree = {"blocks": {}}
    for path in idx:
        d = {"w": Delta(idx[path].to(torch.int32), val[path])}
        if path[0] == "blocks":
            tree["blocks"][path[1]] = d
        else:
            tree["head"] = d
    return tree


@pytest.mark.parametrize("arch", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_matches_program(arch):
    from repro_torch.core.adapt import init_adapters
    from repro_torch.models import get_model

    params = weights.make_params(arch, 7, torch.device("cpu"))
    idx = ref_train.select(arch, params, 2)
    prog_idx, _ = init_adapters(params, 2, strategy="magnitude")
    for p, i in idx.items():
        assert torch.equal(weights.get(prog_idx, p).long(), i)
    g = torch.Generator().manual_seed(3)
    val = {p: (0.05 * torch.randn(i.shape, generator=g)).requires_grad_() for p, i in idx.items()}
    tokens = torch.randint(16, arch.vocab, (2, 24), generator=g)
    model = get_model(model_config(arch))
    got, _ = model.loss(params, _program_adapters(arch, idx, val),
                        {"tokens": tokens, "targets": tokens})
    g_got = torch.autograd.grad(got, list(val.values()))
    want = ref.loss(arch, ref.Weights(arch, params), {p: (idx[p], val[p]) for p in idx}, tokens)
    g_want = torch.autograd.grad(want, list(val.values()))
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-5 * abs(want)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
