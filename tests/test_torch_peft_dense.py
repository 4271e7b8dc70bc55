"""BitFit, the mask-based baseline and full fine-tuning in the port against
``repro.peft`` on the CPU: the comparison of ``test_torch_peft.py`` (its
module docstring states the bounds) on reduced qwen2-1.5b in fp32, and the
MoE family under every method: LoRA fails in both packages, BitFit, masked
and full give the reference's loss on reduced olmoe-1b-7b."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_peft import batch_of, check_method, model_pair, world  # noqa: F401
from repro.configs import PeftConfig as JPeftConfig
from repro.peft import get_peft as j_get_peft
from repro_torch.configs import PeftConfig
from repro_torch.configs import TrainConfig
from repro_torch.peft import get_peft
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import flatten

torch.set_num_threads(2)


@pytest.mark.parametrize("method,strategy", [("bitfit", "magnitude"), ("masked", "magnitude"),
                                             ("masked", "reverse"), ("full", "magnitude")])
def test_method_matches_reference(world, method, strategy):
    check_method(world, method, strategy, "fp32")


def test_masked_leaves_every_unselected_weight_bit_equal(world):
    """Weight decay 0: three masked steps change only the selected entries
    of the adapted matrices; every other entry and every other leaf keeps
    its bits."""
    peft = get_peft(PeftConfig(method="masked", k=2))
    trainable, mask = peft.init(world["tp"])
    step, opt = make_train_step(world["tm"], peft, TrainConfig(steps=3))
    state = TrainState(trainable, opt.init(trainable), torch.zeros((), dtype=torch.int32))
    for i in range(3):
        state, m = step(world["tp"], mask, state,
                        {k: torch.from_numpy(x) for k, x in batch_of(world["cfg"], i).items()})
    moved = 0
    for (p, w), (_, t), (_, mk) in zip(flatten(world["tp"]), flatten(state.trainable),
                                       flatten(mask)):
        assert torch.equal(torch.where(mk, w, t), w), p
        moved += int((t != w).sum())
    assert 0 < moved <= sum(int(mk.sum()) for _, mk in flatten(mask))


def test_lora_cannot_train_moe_in_either_package():
    cfg, jm, jp, tm, tp = model_pair("olmoe-1b-7b")
    batch = batch_of(cfg, 0)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    jloss = jax.jit(lambda p, a: jm.loss(p, a, jb)[0])
    jtr, _ = j_get_peft(JPeftConfig(method="lora")).init(jp, jax.random.PRNGKey(0))
    with pytest.raises(AttributeError):
        jloss(jp, jtr)
    ttr, _ = get_peft(PeftConfig(method="lora")).init(tp, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="moe.py:163-166"):
        tm.loss(tp, ttr, tb)
    # the other methods do train it (the reference's loss)
    for method in ("bitfit", "masked", "full"):
        jpeft, tpeft = j_get_peft(JPeftConfig(method=method)), get_peft(PeftConfig(method=method))
        jt, ja = jpeft.init(jp, jax.random.PRNGKey(0))
        tt, ta = tpeft.init(tp)
        want = float(jloss(*jpeft.model_inputs(jp, jt, ja)))
        got = float(tm.loss(*tpeft.model_inputs(tp, tt, ta), tb)[0])
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want), (method, got, want)
