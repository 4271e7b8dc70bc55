"""The merged export (``train --export``) and ``serve --params`` in the port
against the JAX reference, on the CPU.

Reduced qwen2-1.5b in fp32 on the reference's converted params: the port's
``Trainer.merged_params()`` of given fp32 values equals the reference's
exactly, on a dense base and on a packed one (the export is dense); the
launcher's ``--export`` file is ``save_pytree`` of that tree and loads in
the reference bit for bit; the serve launcher with ``--params`` gives the
reference launcher's greedy tokens on the same npz (with ``--adapters`` and
``--base-dtype`` on top of it as well), and serving the merged export gives
the tokens of serving the unmerged tenant on the same base.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as j_launch_serve
from repro.checkpoint.manager import load_pytree as j_load_pytree
from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.peft import quantize_base as j_quantize_base
from repro.train.trainer import Trainer as JTrainer
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import PeftConfig, TrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.core.adapt import merge_adapters
from repro_torch.data import DataLoader
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.peft import export_adapter, get_peft, load_adapter, quantize_base
from repro_torch.quant import QuantizedTensor
from repro_torch.train import Trainer
from repro_torch.tree import flatten, map_leaves

torch.set_num_threads(2)
NONE = lambda x: x is None  # noqa: E731
ARCH = "qwen2-1.5b"


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(t_reduced(t_get_config(ARCH)).replace(dtype="float32"))
    return {"cfg": cfg, "jm": jm, "jp": jp, "tm": tm, "tp": tree_to_torch(np_tree(jp))}


def trained(world, base="fp32"):
    """A port Trainer after two fp32 steps, and the reference Trainer on
    the same (packed) base holding the port's values."""
    tp = quantize_base(world["tp"], base, block=32)
    tr = Trainer(world["tm"], get_peft(PeftConfig(k=2, delta_dtype="float32")),
                 TrainConfig(steps=2, log_every=0), tp)
    data = DataLoader("lm", world["cfg"].vocab_size, 4, 16, seed=3)
    tr.run(data, steps=2)
    data.close()
    jp = j_quantize_base(world["jp"], base, block=32)
    jt = JTrainer(world["jm"], j_get_peft(JPeftConfig(k=2, delta_dtype="float32")),
                  JTrainConfig(steps=2, log_every=0), jp)
    vals = jax.tree.map(lambda v: None if v is None else v.numpy(), tr.state.trainable,
                        is_leaf=NONE)
    jt.state = jt.state._replace(trainable=jax.tree.map(
        lambda v: None if v is None else jax.numpy.asarray(v), vals, is_leaf=NONE))
    return tr, jt


@pytest.mark.parametrize("base", ["fp32", "int8", "nf4"])
def test_merged_params_equal_the_reference_exactly(world, tmp_path, base):
    tr, jt = trained(world, base)
    path = str(tmp_path / "merged.npz")
    save_pytree(path, tr.merged_params(), {"arch": ARCH, "peft": "neuroada"})
    want = dict(flatten(np_tree(jt.merged_params())))
    got = j_load_pytree(path)  # the port's file, read by the reference
    n = 0
    for p, x in flatten(load_pytree(path)):
        assert not isinstance(x, QuantizedTensor), p  # dense, also from a packed base
        node = got
        for key in p:
            node = node[key]
        np.testing.assert_array_equal(np.asarray(node), want[p], err_msg="/".join(p))
        np.testing.assert_array_equal(x.numpy(), want[p], err_msg="/".join(p))
        n += 1
    assert n == len(want)


def test_launcher_export_is_the_merged_tree(tmp_path, caplog):
    """``--export`` writes the base with the trained adapter folded in: the
    same launch's ``--export-adapter`` merged into the same seed's base."""
    caplog.set_level(logging.INFO)
    merged, adapter = str(tmp_path / "m.npz"), str(tmp_path / "a.npz")
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "8", "--export", merged, "--export-adapter", adapter])
    assert "merged params exported" in caplog.text
    base = get_model(t_reduced(t_get_config(ARCH))).init(seed=0, device="cpu")
    want = dict(flatten(merge_adapters(base, *load_adapter(adapter))))
    got = flatten(load_pytree(merged))
    assert [p for p, _ in got] == list(want)
    for p, x in got:
        assert x.dtype == want[p].dtype and torch.equal(x, want[p]), p


def fp32_launchers(monkeypatch):
    """Both serve launchers on the reduced config in fp32 (the npz files of
    these tests hold fp32 trees)."""
    monkeypatch.setattr(launch_serve, "reduced", lambda c: t_reduced(c).replace(dtype="float32"))
    monkeypatch.setattr(j_launch_serve, "reduced", lambda c: reduced(c).replace(dtype="float32"))


def req_lines(text):
    return [line for line in text.splitlines() if line.startswith("req")]


ARGS = ["--reduced", "--prompts", "1,17,25;1,40,41,42;5,9", "--max-new", "6", "--slots", "2"]


@pytest.mark.parametrize("extra", [[], ["--base-dtype", "int8", "--quant-block", "32"]])
def test_serve_params_gives_the_reference_tokens(world, tmp_path, monkeypatch, capsys, extra):
    tr, _ = trained(world)
    path = str(tmp_path / "merged.npz")
    save_pytree(path, tr.merged_params(), {"arch": ARCH})
    adapter = str(tmp_path / "a.npz")
    export_adapter(adapter, tr.aux, tr.state.trainable)
    fp32_launchers(monkeypatch)
    argv = [*ARGS, "--params", path, *extra]
    for tenant in ([], ["--adapters", adapter, "--adapter-ids", "1,0,1"]):
        j_launch_serve.main(argv + tenant)
        want = req_lines(capsys.readouterr().out)
        launch_serve.main(argv + tenant + ["--device", "cpu"])
        got = req_lines(capsys.readouterr().out)
        assert got == want and len(got) == 3


def test_merged_export_serves_the_unmerged_tenants_tokens(world, tmp_path, monkeypatch,
                                                           capsys):
    tr, _ = trained(world)
    merged, base, adapter = (str(tmp_path / n) for n in ("m.npz", "b.npz", "a.npz"))
    save_pytree(merged, tr.merged_params())
    save_pytree(base, world["tp"])
    export_adapter(adapter, tr.aux, tr.state.trainable)
    fp32_launchers(monkeypatch)
    launch_serve.main([*ARGS, "--device", "cpu", "--params", merged])
    got = [line.replace("[base]", "") for line in req_lines(capsys.readouterr().out)]
    launch_serve.main([*ARGS, "--device", "cpu", "--params", base, "--adapters", adapter])
    want = [line.replace("[tenant1]", "") for line in req_lines(capsys.readouterr().out)]
    assert got == want


def test_params_land_on_the_device_in_their_stored_dtypes(world, tmp_path):
    tree = dict(world["tp"], final_norm=world["tp"]["final_norm"].to(torch.bfloat16))
    tree = quantize_base(tree, "nf4", block=32)
    path = str(tmp_path / "p.npz")
    save_pytree(path, tree)
    loaded = map_leaves(lambda t: None if t is None else t.to("cpu"), load_pytree(path))
    assert loaded["final_norm"].dtype == torch.bfloat16
    assert isinstance(loaded["blocks"]["wq"]["w"], QuantizedTensor)
    assert loaded["blocks"]["wq"]["w"].qdtype == "nf4"
