"""The port's ``finetune_e2e`` twin against the reference's
``examples/finetune_e2e.py`` on the CPU.

* ``build_100m`` equals the reference's config field for field, for
  qwen2-1.5b and olmoe-1b-7b (the reference example is loaded by file path:
  the test may import it, the port may not).
* A cross-package resume at reduced size (float32 model): the reference's
  ``Trainer``, configured as its example configures it (lr 3e-3, 2
  microbatches, checkpoints in a directory, the ``arithmetic`` loader at
  batch 32 x 64, seed 1, host 0 of 1), saves at step 2 of 4; the twin's
  ``run(resume=True)`` continues from that file to 4, and its losses at
  steps 3-4 are within 1e-5 of the reference's uninterrupted run.
* The twin's own save and resume: with checkpoints every 2 steps, a run
  resumed from step 2 repeats the uninterrupted run's steps 3-4 bit for
  bit.
* ``main`` parses its flags and runs (``build_100m`` patched to the reduced
  config: the 90M model takes seconds a step here), and deletes its
  ``--ckpt`` directory unless ``--resume`` is given.
"""

import dataclasses
import importlib.util
import os
import shutil
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.data.loader import DataLoader as JLoader
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.examples import finetune_e2e

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-1.5b"
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


def reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_finetune_e2e", os.path.join(ROOT, "examples", "finetune_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b"])
def test_build_100m_equals_reference(arch):
    want = dataclasses.asdict(reference_example().build_100m(arch))
    got = dataclasses.asdict(finetune_e2e.build_100m(arch))
    assert got == want
    assert got["name"] == arch + "-100m" and got["d_model"] == 768


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config(ARCH)).replace(dtype="float32")
    jp = j_get_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = t_reduced(t_get_config(ARCH)).replace(dtype="float32")
    return {"cfg": cfg, "jp": jp, "tcfg": tcfg, "tp": tree_to_torch(np_tree(jp))}


def reference_run(world, ckpt: str, steps: int) -> list:
    """The reference example's trainer and loader (``examples/finetune_e2e.py
    :54-67``) at 4 scheduled steps, run to ``steps``; its losses."""
    tcfg = JTrainConfig(learning_rate=3e-3, steps=4, microbatches=2, checkpoint_every=100,
                        checkpoint_dir=ckpt, log_every=20)
    trainer = JTrainer(j_get_model(world["cfg"]), j_get_peft(JPeftConfig(method="neuroada", k=1)),
                       tcfg, world["jp"])
    start = trainer.try_resume()
    data = JLoader("arithmetic", world["cfg"].vocab_size, 32, 64, seed=1, start_step=start,
                   host_id=0, host_count=1)
    try:
        return [h["loss"] for h in trainer.run(data, steps=steps)]
    finally:
        data.close()


def test_reference_checkpoint_resumes_in_the_twin(world, tmp_path):
    want = reference_run(world, str(tmp_path / "full"), 4)
    assert reference_run(world, str(tmp_path / "ck"), 2) == pytest.approx(want[:2], rel=1e-6)
    assert sorted(os.listdir(tmp_path / "ck"))[0] == "ckpt_00000002.npz"
    got = finetune_e2e.run(world["tcfg"], world["tp"], steps=4, ckpt=str(tmp_path / "ck"),
                           k=1, resume=True, device="cpu")
    assert got["start"] == 2 and sorted(got["losses"]) == [2, 3]
    np.testing.assert_allclose([got["losses"][2], got["losses"][3]], want[2:], rtol=1e-5)
    assert got["checkpoints"] == [2, 4] and got["skipped"] == 0


def test_twin_resume_is_bit_exact(world, tmp_path, monkeypatch):
    monkeypatch.setattr(finetune_e2e, "CHECKPOINT_EVERY", 2)
    full = finetune_e2e.run(world["tcfg"], world["tp"], steps=4, ckpt=str(tmp_path / "a"),
                            k=1, device="cpu")
    assert full["start"] == 0 and sorted(full["losses"]) == [0, 1, 2, 3]
    assert full["checkpoints"] == [2, 4]
    # the state at step 2 alone, as a run killed before its step-4 save leaves it
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    for f in os.listdir(tmp_path / "b"):
        if f.startswith("ckpt_00000004"):
            os.remove(tmp_path / "b" / f)
    got = finetune_e2e.run(world["tcfg"], world["tp"], steps=4, ckpt=str(tmp_path / "b"),
                           k=1, resume=True, device="cpu")
    assert got["start"] == 2
    assert got["losses"] == {2: full["losses"][2], 3: full["losses"][3]}


def test_main_parses_runs_and_clears_its_directory(world, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(finetune_e2e, "build_100m", lambda arch: world["tcfg"])
    ckpt = tmp_path / "ck"
    ckpt.mkdir()
    (ckpt / "ckpt_00000050.npz").write_bytes(b"stale")
    out = finetune_e2e.main(["--steps", "2", "--device", "cpu", "--ckpt", str(ckpt)])
    assert out["start"] == 0 and out["checkpoints"] == [2]
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000002.npz", "ckpt_00000002.npz.meta.json"]
    again = finetune_e2e.main(["--steps", "3", "--device", "cpu", "--ckpt", str(ckpt),
                               "--resume"])
    assert again["start"] == 2 and sorted(again["losses"]) == [2]
    text = capsys.readouterr().out
    assert "stragglers flagged: 0; skipped (NaN-guard): 0" in text
    assert f"checkpoints: [2, 3] in {ckpt}" in text
    # the twin's default directory is not the reference example's, which
    # that example deletes unless --resume is given
    with open(os.path.join(ROOT, "examples", "finetune_e2e.py")) as f:
        assert 'default="/tmp/repro_e2e_ckpt"' in f.read()
    assert finetune_e2e.DEFAULT_CKPT == os.path.join(tempfile.gettempdir(),
                                                     "repro_torch_e2e_ckpt")
