"""Activation recomputation (``remat``) in the port, on the CPU.

Reduced qwen2-1.5b and olmoe-1b-7b in fp32: ``none``, ``full`` and ``dots``
give bit-identical losses and values over three AdamW steps (recomputation
reruns the same operations on the same inputs), and each mode matches the
reference's ``make_train_step`` with the same ``remat`` within the
tolerances of ``test_torch_train.py``. Launches (plain calls on the CPU): a
step under ``full`` runs every forward kernel of a layer twice — the fused
linears, the MoE expert bypasses and the flash forward — under ``dots``
the fused linears once (their outputs kept) and the rest twice, and the
value gradients once in every mode. The launcher takes ``--remat``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.data.synthetic import TASKS as J_TASKS
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.kernels import COUNTERS, ops, reset_counters
from repro_torch.launch import train as launch
from repro_torch.models import get_model
from repro_torch.peft import get_peft
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import flatten

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
ARCHS = ("qwen2-1.5b", "olmoe-1b-7b")
MODES = ("none", "full", "dots")


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module", params=ARCHS)
def world(request):
    cfg = reduced(get_config(request.param)).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config(request.param)).replace(dtype="float32"))
    batches = [J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i) for i in range(3)]
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "batches": batches}


def port_steps(world, remat, model=None):
    """Three steps under ``remat``: (losses, values after each step, the
    plain calls of the first step by kernel)."""
    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    step, opt = make_train_step(model or world["tm"], peft, TrainConfig(steps=3, remat=remat))
    vals, idx = peft.init(world["tp"])
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    losses, values, calls = [], [], None
    for i, batch in enumerate(world["batches"]):
        reset_counters()
        state, m = step(world["tp"], idx, state,
                        {k: torch.from_numpy(x) for k, x in batch.items()})
        if i == 0:
            calls = {n: c.plain for n, c in COUNTERS.items() if c.plain}
        losses.append(float(m["loss"]))
        values.append([v.clone() for _, v in flatten(state.trainable) if v is not None])
    return losses, values, calls


@pytest.fixture(scope="module")
def runs(world):
    return {mode: port_steps(world, mode) for mode in MODES}


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_modes_give_bit_identical_losses_and_values(world, runs, mode):
    want_loss, want_vals, _ = runs["none"]
    got_loss, got_vals, _ = runs[mode]
    assert got_loss == want_loss
    for step, (a, b) in enumerate(zip(got_vals, want_vals)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"step {step}"


@pytest.mark.parametrize("mode", MODES)
def test_each_mode_matches_the_reference(world, runs, mode):
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jstep, jopt = j_make_train_step(world["jm"], jpeft, JTrainConfig(steps=3, remat=mode))
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(world["jp"], jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))
    losses, values, _ = runs[mode]
    for i, batch in enumerate(world["batches"]):
        jstate, jm = jstep(world["jp"], jidx, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        np.testing.assert_allclose(losses[i], float(jm["loss"]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"step {i}")
        want = [x for _, x in flatten(np_tree(jstate.trainable)) if x is not None]
        for got, w in zip(values[i], want):
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-4 * 3e-3,
                                       err_msg=f"step {i}")


def test_launches_per_mode(world, runs):
    """The first step's plain calls: ``full`` doubles every forward kernel
    of a layer, ``dots`` all but the fused linears; the value gradients
    never change."""
    cfg = world["cfg"]
    none, full, dots = (runs[m][2] for m in MODES)
    L = cfg.num_layers
    assert full["fused_linear"] == 2 * none["fused_linear"] and none["fused_linear"] > 0
    assert dots["fused_linear"] == none["fused_linear"]
    assert none["sparse_delta_dval"] == full["sparse_delta_dval"] == dots["sparse_delta_dval"]
    if cfg.num_experts:  # the three expert bypasses of every layer run again
        assert full["sparse_delta"] == dots["sparse_delta"] == none["sparse_delta"] + 3 * L


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_flash_forward_is_recomputed(world, mode):
    """On the flash path (threshold lowered to the batch's 16 tokens) the
    flash forward runs again in the backward in both modes, with the same
    losses as without recomputation."""
    cfg = world["tm"].cfg.replace(flash_threshold=16, flash_block=8)
    model = get_model(cfg)
    world = dict(world, batches=world["batches"][:1])
    want = port_steps(world, "none", model)
    got = port_steps(world, mode, model)
    assert got[0] == want[0]
    assert got[2]["flash_attention_fwd"] == 2 * want[2]["flash_attention_fwd"] == 2 * cfg.num_layers


def test_keep_linear_outputs_replays_in_order():
    """Outside its contexts a fused linear launches; inside the forward
    context it launches and keeps its output; inside the recompute context
    it hands the kept outputs back in order, launching nothing."""
    fwd, rec = ops.keep_linear_outputs()
    launches = []

    def launch(v):
        launches.append(v)
        return torch.full((2,), float(v))

    assert ops._kept(lambda: launch(0))[0] == 0.0
    with fwd:
        a, b = ops._kept(lambda: launch(1)), ops._kept(lambda: launch(2))
    with rec:
        c, d = ops._kept(lambda: launch(9)), ops._kept(lambda: launch(9))
    assert launches == [0, 1, 2] and torch.equal(a, c) and torch.equal(b, d)
    assert ops._KEEP is None


def test_unknown_mode_and_the_launcher(world):
    batch = {k: torch.from_numpy(x) for k, x in world["batches"][0].items()}
    with pytest.raises(ValueError, match="remat"):
        world["tm"].loss(world["tp"], None, batch, remat="some")
    if world["cfg"].num_experts:
        return
    got = {m: launch.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq", "8", "--remat", m]) for m in MODES}
    assert [h["loss"] for h in got["full"]] == [h["loss"] for h in got["none"]]
    assert [h["loss"] for h in got["dots"]] == [h["loss"] for h in got["none"]]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_remat_launches_and_values(arch):
    """On the card: ``full`` launches every fused linear twice a step,
    ``dots`` once, the value gradient once in every mode; the first loss
    is bit-equal across the modes and, under deterministic algorithms (the
    backward's ``index_add_``), so are the values after two steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = t_reduced(t_get_config(arch)).replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(seed=0, device="cuda")
    batches = [{k: torch.from_numpy(x).cuda() for k, x in
                J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i).items()} for i in range(2)]
    got = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for mode in MODES:
            peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
            step, opt = make_train_step(model, peft, TrainConfig(steps=2, remat=mode))
            vals, idx = peft.init(params)
            state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32,
                                                                 device="cuda"))
            reset_counters()
            losses = []
            for b in batches:
                state, m = step(params, idx, state, b)
                losses.append(float(m["loss"]))
            got[mode] = (losses, [v for _, v in flatten(state.trainable) if v is not None],
                         {n: c.kernel for n, c in COUNTERS.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    n = got["none"][2]
    assert got["full"][2]["fused_linear"] == 2 * n["fused_linear"] > 0
    assert got["dots"][2]["fused_linear"] == n["fused_linear"]
    for mode in ("full", "dots"):
        assert got[mode][2]["sparse_delta_dval"] == n["sparse_delta_dval"]
        assert got[mode][0] == got["none"][0]
        assert all(torch.equal(a, b) for a, b in zip(got[mode][1], got["none"][1]))
