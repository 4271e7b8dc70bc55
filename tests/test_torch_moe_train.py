"""NeuroAda training of the MoE family in the port against the JAX
reference, on the CPU.

Reduced olmoe-1b-7b in fp32 (2 layers, d 64, 4 experts top-2, untied
head), the reference's random params converted leaf by leaf:

* magnitude selection over the expert stacks gives the reference's
  ``(L, E, k, F)`` indices, the untied head is adapted, the router is not;
* ``Model.loss`` (cross-entropy plus ``router_aux_coef`` × the aux loss)
  within 1e-5 and the gradient of every adapted matrix's values (attention,
  the three expert stacks, the head) within rtol 1e-4, against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` on its jnp backend
  (its Pallas kernels in interpret mode: ``test_torch_moe_train_interpret.py``);
* three AdamW steps against the reference's ``make_train_step``;
* adapter files with expert stacks across packages, the trainable and
  total counts, the launcher.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.core.adapt import init_adapters as j_init_adapters
from repro.core.adapt import zip_adapters as j_zip
from repro.data import peek_batch as j_peek
from repro.data.synthetic import TASKS as J_TASKS
from repro.models import get_model as j_get_model
from repro.peft import export_adapter as j_export_adapter
from repro.peft import get_peft as j_get_peft
from repro.peft import load_adapter as j_load_adapter
from repro.train import TrainState as JState
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.core.adapt import init_adapters, zip_adapters
from repro_torch.kernels import COUNTERS, SINGLE_TENANT, TRAINING, reset_counters
from repro_torch.launch import train as launch
from repro_torch.models import get_model
from repro_torch.peft import export_adapter, get_peft, load_adapter, stats
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
ADAPTED = 8  # wq wk wv wo, the three expert stacks, the head


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def make_world(num_layers=2):
    cfg = reduced(get_config("olmoe-1b-7b")).replace(dtype="float32", num_layers=num_layers)
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config("olmoe-1b-7b")).replace(dtype="float32",
                                                                 num_layers=num_layers))
    idx, val = j_init_adapters(jp, 2)
    rng = np.random.default_rng(7)
    val = jax.tree.map(lambda v: None if v is None else
                       jnp.asarray(0.05 * rng.standard_normal(v.shape), jnp.float32),
                       val, is_leaf=NONE)
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp)),
            "idx": idx, "val": val}


@pytest.fixture(scope="module")
def world():
    return make_world()


def port_loss_and_grads(world, batch):
    tv = map_leaves(lambda v: None if v is None else v.requires_grad_(),
                    tree_to_torch(np_tree(world["val"])))
    loss, metrics = world["tm"].loss(world["tp"],
                                     zip_adapters(tree_to_torch(np_tree(world["idx"])), tv),
                                     {k: torch.from_numpy(np.asarray(x)) for k, x in batch.items()})
    loss.backward()
    return loss.detach(), metrics, {p: v.grad for p, v in flatten(tv) if v is not None}


def assert_grads_close(grads, jgrads):
    want = dict(flatten(np_tree(jgrads)))
    assert set(grads) == {p for p, v in want.items() if v is not None}
    assert len(grads) == ADAPTED
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-4 * np.abs(want[path]).max(), err_msg=str(path))


def test_selection_covers_experts_and_head_like_reference(world):
    idx, _ = init_adapters(world["tp"], 2)
    want = dict(flatten(np_tree(world["idx"])))
    got = dict(flatten(idx))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        assert (leaf is None) == (want[path] is None), path
        if leaf is not None:
            np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=str(path))
    cfg = world["tm"].cfg
    e, f, d = cfg.num_experts, cfg.d_ff, cfg.d_model
    assert got[("blocks", "wgate", "w")].shape == (2, e, 2, f)
    assert got[("blocks", "wdown", "w")].shape == (2, e, 2, d)
    assert got[("head", "w")].shape == (2, cfg.padded_vocab)
    assert got[("blocks", "router", "w")] is None


@pytest.mark.parametrize("task", ["lm", "reasoning"])
def test_loss_and_value_gradients_match_reference_jnp(world, task):
    batch = j_peek(task, world["cfg"].vocab_size, 2, 16, seed=3)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}
    (jloss, jmet), jg = jax.value_and_grad(
        lambda v: world["jm"].loss(world["jp"], j_zip(world["idx"], v), jb), has_aux=True
    )(world["val"])
    reset_counters()
    loss, metrics, grads = port_loss_and_grads(world, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jmet["ce"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"].detach()), float(jmet["aux"]), rtol=1e-5)
    assert float(metrics["aux"].detach()) > 0
    assert_grads_close(grads, jg)
    # per layer: 4 fused projections and 3 expert stacks; then the head
    launches = {n: COUNTERS[n].plain for n in TRAINING + SINGLE_TENANT}
    assert launches == {"fused_linear": 8, "sparse_delta": 7, "sparse_delta_dval": 15}


def test_three_train_steps_match_reference(world):
    """Loss, ce, aux, grad_norm and the values after each of three AdamW
    steps against the reference's jitted step on its jnp backend (fp32
    values; tolerances as for the dense family)."""
    cfg = world["cfg"]
    jpeft = j_get_peft(JPeftConfig(k=1, delta_dtype="float32"))
    jstep, jopt = j_make_train_step(world["jm"], jpeft, JTrainConfig(steps=3))
    jstep = jax.jit(jstep)
    jvals, jidx = jpeft.init(world["jp"], jax.random.PRNGKey(0))
    jstate = JState(jvals, jopt.init(jvals), jnp.zeros((), jnp.int32))
    peft = get_peft(PeftConfig(k=1, delta_dtype="float32"))
    tc = TrainConfig(steps=3)
    step, opt = make_train_step(world["tm"], peft, tc)
    vals, idx = peft.init(world["tp"])
    state = TrainState(vals, opt.init(vals), torch.zeros((), dtype=torch.int32))
    for i in range(3):
        batch = J_TASKS["reasoning"](cfg.vocab_size, 4, 16, 0, i)
        jstate, jm = jstep(world["jp"], jidx, jstate, {k: jnp.asarray(x) for k, x in batch.items()})
        state, m = step(world["tp"], idx, state,
                        {k: torch.from_numpy(x) for k, x in batch.items()})
        for key in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {key}")
        assert int(m["skipped"]) == int(jm["skipped"]) == 0
        want = dict(flatten(np_tree(jstate.trainable)))
        n = 0
        for path, v in flatten(state.trainable):
            if v is None:
                continue
            np.testing.assert_allclose(v.numpy(), want[path], rtol=1e-5,
                                       atol=1e-4 * tc.learning_rate, err_msg=f"step {i} {path}")
            n += 1
        assert n == ADAPTED


def test_counts_and_adapter_files_cross_packages(world, tmp_path):
    """k = 1: one value per output neuron of every adapted matrix, the
    expert stacks' E of them and the head's included; an npz with expert
    stacks written by either package loads in the other, bit for bit."""
    cfg = world["tm"].cfg
    peft = get_peft(PeftConfig(k=1))
    vals, idx = peft.init(world["tp"])
    st = stats(world["tp"], vals)
    hd, e = cfg.resolved_head_dim, cfg.num_experts
    per_layer = cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd + cfg.d_model \
        + e * (2 * cfg.d_ff + cfg.d_model)
    assert st["trainable"] == cfg.num_layers * per_layer + cfg.padded_vocab
    assert st["total"] == sum(x.size for _, x in flatten(np_tree(world["jp"])) if x is not None)
    vals = map_leaves(lambda v: None if v is None else v + 0.25, vals)
    path = str(tmp_path / "port.npz")
    export_adapter(path, idx, vals)
    jidx, jval = j_load_adapter(path)
    for (p, a), (_, b) in zip(flatten(vals), flatten(np_tree(jval))):
        assert (a is None) == (b is None), p
        if a is not None:
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    assert np.asarray(jidx["blocks"]["wup"]["w"]).shape == (2, e, 1, cfg.d_ff)
    back = str(tmp_path / "ref.npz")
    j_export_adapter(back, jidx, jval)
    lidx, lval = load_adapter(back)
    for (p, a), (_, b) in zip(flatten(idx), flatten(lidx)):
        assert (a is None and b is None) or torch.equal(a, b), p


def test_launcher_trains_olmoe_and_exports_on_the_cpu(tmp_path, caplog):
    out = tmp_path / "m.npz"
    with caplog.at_level("INFO"):
        hist = launch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                            "--steps", "3", "--batch", "4", "--seq", "16",
                            "--export-adapter", str(out)])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["aux"] > 0 for h in hist)
    assert "olmoe-1b-7b-reduced" in caplog.text
    idx, val = j_load_adapter(str(out))
    assert val["head"]["w"].dtype == jnp.bfloat16
    assert idx["blocks"]["wdown"]["w"].shape[:2] == (2, 4)


@pytest.mark.parametrize("base", ["int8", "nf4"])
def test_launcher_refuses_a_packed_base_on_moe(base, caplog):
    """No longer refused: the launcher packs olmoe's expert stacks and
    trains on them (parity with the reference in
    ``test_torch_moe_quant.py``)."""
    caplog.set_level(logging.INFO)
    hist = launch.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                        "--base-dtype", base, "--steps", "1", "--batch", "2", "--seq", "8"])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert f"base quantized to {base}" in caplog.text
