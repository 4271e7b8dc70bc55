"""Checkpoints and resume in the port against the JAX reference, on the CPU.

``repro_torch.checkpoint``: a tree with bf16, ``None``, packed and named-tuple
leaves round-trips through ``save_pytree`` / ``load_pytree`` /
``restore_into`` bit for bit; ``CheckpointManager`` keeps the last N files,
restores the latest, copies to the host before its writer thread starts and
raises a failed asynchronous write at the next ``wait()``; ``restore_into``
keeps the reference's packed/dense errors. ``Trainer.try_resume`` continues
a run exactly (the twin of ``tests/train/test_checkpoint.py::test_resume_exact``),
and a checkpoint crosses the packages both ways: the reference's
``CheckpointManager`` writes at step 2 and the port resumes to the
reference's uninterrupted losses; the port writes and the reference's
``restore_into`` loads it exactly — for NeuroAda, and for LoRA (dict
leaves) and BitFit (a tree of ``None`` leaves and copies) too. The
launcher's ``--ckpt`` / ``--resume``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import load_pytree as j_load_pytree
from repro.checkpoint.manager import restore_into as j_restore_into
from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.data import DataLoader as JLoader
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.train.trainer import Trainer as JTrainer
from repro_torch import checkpoint as ckpt_mod
from repro_torch.checkpoint import CheckpointManager, load_pytree, restore_into, save_pytree
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.data import DataLoader
from repro_torch.launch import train as launch
from repro_torch.models import get_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.peft import get_peft
from repro_torch.quant import QuantizedTensor, quantize
from repro_torch.train import Trainer
from repro_torch.tree import flatten

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
ARCH = "qwen2-1.5b"


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def sample_tree():
    g = torch.Generator().manual_seed(0)
    return {
        "a": {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16), "b": None},
        "q": quantize(torch.randn(2, 8, 6, generator=g), "nf4", 4),
        "opt": AdamWState(torch.tensor(7, dtype=torch.int32),
                          {"x": torch.randn(4, generator=g), "y": None},
                          {"x": torch.rand(4, generator=g), "y": None}),
    }


def assert_same(a, b):
    pa, pb = flatten(a), flatten(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        if x is None:
            assert y is None, p
        elif isinstance(x, QuantizedTensor):
            assert isinstance(y, QuantizedTensor)
            assert (x.qdtype, x.block, x.dtype_name) == (y.qdtype, y.block, y.dtype_name)
            assert torch.equal(x.data, y.data) and torch.equal(x.scales, y.scales), p
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), p


# ------------------------------------------------------------ the files


def test_tree_round_trips_bf16_none_packed_and_named_tuples(tmp_path):
    tree = sample_tree()
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree, {"arch": "x"})
    flat = np.load(path)
    assert "opt/mu/x" in flat.files and "opt/step" in flat.files  # field names
    assert flat["a/w"].dtype == np.uint16 and str(flat["__dtype__/a/w"]) == "bfloat16"
    assert str(flat["a/b"]) == "__none__"
    loaded = load_pytree(path)
    assert isinstance(loaded["opt"], dict)  # restore_into rebuilds the named tuple
    back = restore_into(tree, loaded)
    assert isinstance(back["opt"], AdamWState)
    assert_same(tree, back)


def test_manager_keeps_the_last_n_and_restores_the_latest(tmp_path):
    m = CheckpointManager(str(tmp_path / "run"), keep=2)
    assert m.restore_latest() == (None, None)
    for step in (1, 2, 3, 4):
        m.save(step, {"v": torch.full((3,), float(step))}, metadata={"peft": "neuroada"})
    m.wait()
    assert m.steps() == [3, 4]
    assert sorted(os.listdir(m.dir)) == ["ckpt_00000003.npz", "ckpt_00000003.npz.meta.json",
                                         "ckpt_00000004.npz", "ckpt_00000004.npz.meta.json"]
    step, tree = m.restore_latest()
    assert step == 4 and torch.equal(tree["v"], torch.full((3,), 4.0))
    assert m.last_copy_s >= 0 and m.last_write_s > 0


def test_save_copies_to_the_host_before_the_writer_starts(tmp_path, monkeypatch):
    """The writer sees host tensors that the caller can no longer change:
    the state is updated in place right after ``save`` returns."""
    seen = []
    real = ckpt_mod.save_pytree

    def slow(path, tree, meta):
        seen.append(tree)
        real(path, tree, meta)

    monkeypatch.setattr(ckpt_mod, "save_pytree", slow)
    m = CheckpointManager(str(tmp_path))
    v = torch.zeros(4)
    m.save(1, {"v": v, "opt": AdamWState(torch.tensor(1), {"v": v}, {"v": v})})
    v += 1.0  # the next train step
    m.wait()
    leaves = [x for _, x in flatten(seen[0])]
    assert all(x.device.type == "cpu" and x.data_ptr() != v.data_ptr() for x in leaves)
    assert torch.equal(load_pytree(m._path(1))["v"], torch.zeros(4))


def test_async_write_error_surfaces_at_wait(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "save_pytree", broken)
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"v": torch.zeros(2)})  # does not raise here
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as e:
        m.wait()
    assert isinstance(e.value.__cause__, OSError)
    m.wait()  # reported once
    with pytest.raises(RuntimeError):  # the next save waits, and raises, first
        m.save(2, {"v": torch.zeros(2)})
        m.wait()


def test_restore_into_keeps_the_reference_errors():
    packed = {"w": quantize(torch.randn(8, 4), "int8", 4)}
    dense = {"w": torch.randn(8, 4)}
    with pytest.raises(ValueError, match="dense but the template expects a packed"):
        restore_into(packed, dense)
    with pytest.raises(ValueError, match="packed QuantizedTensor but the template expects"):
        restore_into(dense, packed)
    with pytest.raises(ValueError, match="same --base-dtype/--quant-block"):
        restore_into(packed, {"w": quantize(torch.randn(8, 4), "int8", 2)})
    # dtypes come from the template, values from the file
    got = restore_into({"w": torch.zeros(2, dtype=torch.bfloat16)},
                       {"w": torch.tensor([1.5, -2.0])})
    assert got["w"].dtype == torch.bfloat16 and got["w"].tolist() == [1.5, -2.0]


# ------------------------------------------------------------ resume


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config(ARCH)).replace(dtype="float32"))
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp))}


def port_trainer(world, ckdir, every=2, delta_dtype="float32", params=None):
    tcfg = TrainConfig(steps=4, log_every=0, checkpoint_every=every, checkpoint_dir=ckdir)
    return Trainer(world["tm"], get_peft(PeftConfig(k=2, delta_dtype=delta_dtype)), tcfg,
                   world["tp"] if params is None else params)


def ref_trainer(world, ckdir, every=2, delta_dtype="float32"):
    tcfg = JTrainConfig(steps=4, log_every=0, checkpoint_every=every, checkpoint_dir=ckdir)
    return JTrainer(world["jm"], j_get_peft(JPeftConfig(k=2, delta_dtype=delta_dtype)), tcfg,
                    world["jp"])


def run(trainer, steps, start=0, loader=DataLoader):
    data = loader("lm", trainer.model.cfg.vocab_size, 4, 16, seed=9, start_step=start)
    try:
        return [h["loss"] for h in trainer.run(data, steps=steps)]
    finally:
        data.close()


def test_resume_exact(world, tmp_path):
    """4 uninterrupted steps against 2 + a fresh Trainer resumed at 2: the
    restored state equals the saved one and the losses and values equal
    the uninterrupted run's (bf16 values, the launcher's default)."""
    full = port_trainer(world, str(tmp_path / "full"), delta_dtype="bfloat16")
    want = run(full, 4)
    a = port_trainer(world, str(tmp_path / "ck"), delta_dtype="bfloat16")
    got = run(a, 2)
    saved = {"trainable": a.state.trainable, "opt_state": a.state.opt_state}
    b = port_trainer(world, str(tmp_path / "ck"), delta_dtype="bfloat16")
    assert b.try_resume() == 2 and int(b.state.step) == 2
    assert_same(saved, {"trainable": b.state.trainable, "opt_state": b.state.opt_state})
    got += run(b, 4, start=2)
    assert got == want
    assert_same(full.state.trainable, b.state.trainable)
    assert a.ckpt.steps() == [2, 4]  # A's periodic save and its final one; B's at 4
    assert port_trainer(world, str(tmp_path / "empty")).try_resume() == 0


def test_reference_checkpoint_resumes_in_the_port(world, tmp_path):
    """The reference writes at step 2; the port resumes and its steps 3-4
    match the reference's uninterrupted losses within 1e-5."""
    want = run(ref_trainer(world, str(tmp_path / "jfull")), 4, loader=JLoader)
    jt = ref_trainer(world, str(tmp_path / "j"))
    run(jt, 2, loader=JLoader)
    b = port_trainer(world, str(tmp_path / "j"))
    assert b.try_resume() == 2
    # the restored state is the reference's, exactly
    j_state = dict(flatten(np_tree(jt.state.trainable)))
    for p, v in flatten(b.state.trainable):
        if v is not None:
            np.testing.assert_array_equal(v.numpy(), j_state[p])
    got = run(b, 4, start=2)
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)


def test_port_checkpoint_loads_exactly_in_the_reference(world, tmp_path):
    """The port writes (bf16 values: uint16 bits + the dtype sidecar,
    ``None`` leaves, ``opt_state/step|mu|nu``); the reference's
    ``restore_into`` maps it onto its own state exactly."""
    a = port_trainer(world, str(tmp_path / "t"), delta_dtype="bfloat16")
    run(a, 2)
    jt = ref_trainer(world, str(tmp_path / "unused"), delta_dtype="bfloat16")
    tree = j_load_pytree(a.ckpt._path(2))
    jv = j_restore_into(jt.state.trainable, tree["trainable"])
    jo = j_restore_into(jt.state.opt_state, tree["opt_state"])
    assert int(jo.step) == 2
    for (p, x), (_, y) in zip(flatten(a.state.trainable), flatten(np_tree(jv))):
        assert (x is None) == (y is None), p
        if x is not None:
            assert y.dtype == jnp.bfloat16
            np.testing.assert_array_equal(x.float().numpy(), np.asarray(y, np.float32))
    for name in ("mu", "nu"):
        got = dict(flatten(getattr(a.state.opt_state, name)))
        for p, y in flatten(np_tree(getattr(jo, name))):
            assert (got[p] is None) == (y is None), p
            if y is not None:
                np.testing.assert_array_equal(got[p].numpy(), y)


def method_trainer(world, ckdir, method):
    tcfg = TrainConfig(steps=4, log_every=0, checkpoint_every=2, checkpoint_dir=ckdir)
    return Trainer(world["tm"], get_peft(PeftConfig(method=method, lora_rank=4)), tcfg,
                   world["tp"])


@pytest.mark.parametrize("method", ["lora", "bitfit"])
def test_resume_exact_under_other_methods(world, tmp_path, method):
    """A LoRA and a BitFit run resumed at step 2 equal the uninterrupted run
    bit for bit: the restored state, the losses and the trainables."""
    full = method_trainer(world, str(tmp_path / "full"), method)
    want = run(full, 4)
    a = method_trainer(world, str(tmp_path / "ck"), method)
    got = run(a, 2)
    saved = {"trainable": a.state.trainable, "opt_state": a.state.opt_state}
    b = method_trainer(world, str(tmp_path / "ck"), method)
    assert b.try_resume() == 2
    assert_same(saved, {"trainable": b.state.trainable, "opt_state": b.state.opt_state})
    got += run(b, 4, start=2)
    assert got == want
    assert_same(full.state.trainable, b.state.trainable)


@pytest.mark.parametrize("method", ["lora", "bitfit"])
def test_checkpoints_of_other_methods_cross_packages(world, tmp_path, method):
    """The reference writes at step 2 and the port resumes it exactly (its
    steps 3-4 within 1e-5 of the reference's uninterrupted losses); the
    port writes at step 2 and the reference's ``restore_into`` maps it onto
    its own state exactly."""
    jcfg = dict(steps=4, log_every=0, checkpoint_every=2)
    jpc = JPeftConfig(method=method, lora_rank=4)
    want = run(JTrainer(world["jm"], j_get_peft(jpc), JTrainConfig(
        checkpoint_dir=str(tmp_path / "jfull"), **jcfg), world["jp"]), 4, loader=JLoader)
    jt = JTrainer(world["jm"], j_get_peft(jpc), JTrainConfig(checkpoint_dir=str(tmp_path / "j"),
                                                             **jcfg), world["jp"])
    run(jt, 2, loader=JLoader)
    b = method_trainer(world, str(tmp_path / "j"), method)
    assert b.try_resume() == 2
    j_state = dict(flatten(np_tree(jt.state.trainable)))
    for p, v in flatten(b.state.trainable):
        assert (v is None) == (j_state[p] is None), p
        if v is not None:
            np.testing.assert_array_equal(v.numpy(), j_state[p])
    np.testing.assert_allclose(run(b, 4, start=2), want[2:], rtol=1e-5)

    a = method_trainer(world, str(tmp_path / "t"), method)
    run(a, 2)
    tree = j_load_pytree(a.ckpt._path(2))
    jv = j_restore_into(jt.state.trainable, tree["trainable"])
    jo = j_restore_into(jt.state.opt_state, tree["opt_state"])
    assert int(jo.step) == 2
    for want_tree, got_tree in ((a.state.trainable, jv), (a.state.opt_state.mu, jo.mu),
                                (a.state.opt_state.nu, jo.nu)):
        got = dict(flatten(np_tree(got_tree)))
        for p, x in flatten(want_tree):
            assert (x is None) == (got[p] is None), p
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), got[p])


def test_launcher_checkpoints_and_resumes(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    ck = str(tmp_path / "run")
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "8", "--ckpt", ck]
    first = launch.main([*argv, "--steps", "2"])
    assert CheckpointManager(ck).steps() == [2]
    rest = launch.main([*argv, "--steps", "3", "--resume"])
    assert "resumed from step 2" in caplog.text
    assert len(first) == 2 and [h["step"] for h in rest] == [2]
    assert np.isfinite(rest[0]["loss"])
    assert CheckpointManager(ck).steps() == [2, 3]
