"""The port's ``peft_comparison`` twin against the reference's on the CPU:
each of the six rows of ``examples/peft_comparison.py`` (NeuroAda k = 1 and
16, LoRA rank 4, BitFit, masked k = 16, full), with its hyperparameters,
through ``benchmarks.common.train_and_eval`` and through
``repro_torch.examples.common.train_and_eval`` at 3 steps, from the
reference's reduced qwen2-1.5b params (float32 model; every parity test of
the port holds float32), converted leaf by leaf.

Held: ``fraction``, ``opt_state_bytes`` and ``trainable_bytes`` exactly,
``final_loss`` within 1e-5 relative, ``acc`` equal. LoRA's ``A`` is drawn
by JAX's PRNG, which torch cannot repeat: the twin starts from the
reference's initial tree (as ``tests/test_torch_peft.py`` does). The rows
split over this file (the NeuroAda and LoRA rows) and
``test_torch_examples_peft_dense.py`` (BitFit, masked, full), which imports
this file's helpers. Also here: the twin's table prints the reference's
header and one row a method.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import train_and_eval as j_train_and_eval
from repro.configs import PeftConfig as JPeftConfig
from repro.configs import get_config, reduced
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.examples import common, peft_comparison
from repro_torch.kernels import COUNTERS, reset_counters
from repro_torch.models import get_model

torch.set_num_threads(2)
STEPS = 3
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32")
    return {"cfg": cfg, "jm": jm, "jp": jp, "tcfg": tcfg, "tm": get_model(tcfg),
            "tp": tree_to_torch(np_tree(jp))}


def reference_init(world, method: str, kw: dict):
    """The reference trainer's initial trainable tree of one row
    (``peft.init`` under its ``PRNGKey(tcfg.seed)``), as port tensors."""
    pcfg = JPeftConfig(method=method, k=kw.get("k", 1), lora_rank=kw.get("lora_rank", 4))
    trainable, _ = j_get_peft(pcfg).init(world["jp"], jax.random.PRNGKey(0))
    return tree_to_torch(np_tree(trainable))


def check_row(world, row: int, monkeypatch):
    method, kw = peft_comparison.ROWS[row]
    want = j_train_and_eval(world["cfg"], world["jm"], world["jp"], method, steps=STEPS,
                            task="reasoning", **kw)
    if method == "lora":
        start = reference_init(world, method, kw)
        real = common.get_peft

        def get_peft(pcfg):
            peft = real(pcfg)
            return peft._replace(init=lambda params, rng=None: (start, peft.init(params, rng)[1]))

        monkeypatch.setattr(common, "get_peft", get_peft)
    reset_counters()
    got = common.train_and_eval(world["tcfg"], world["tm"], world["tp"], method, steps=STEPS,
                                task="reasoning", device="cpu", **kw)
    for key in ("method", "fraction", "opt_state_bytes", "trainable_bytes", "acc"):
        assert got[key] == want[key], key
    assert got["final_loss"] == pytest.approx(want["final_loss"], rel=1e-5)
    assert got["samples_per_s"] > 0 and got["us_per_step"] > 0
    # the kernels of the card's run: selection for NeuroAda and masked, the
    # bypass forward and value gradient for NeuroAda, none for the others
    selects = method in ("neuroada", "masked")
    assert (COUNTERS["topk_select"].plain > 0) == selects
    assert (COUNTERS["fused_linear"].plain > 0) == (method == "neuroada")
    assert (COUNTERS["sparse_delta_dval"].plain > 0) == (method == "neuroada")


@pytest.mark.parametrize("row", [0, 1, 2])
def test_row_matches_reference(world, row, monkeypatch):
    check_row(world, row, monkeypatch)


def test_table_prints_the_reference_header(world, monkeypatch):
    monkeypatch.setattr(peft_comparison, "ROWS", peft_comparison.ROWS[:1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = peft_comparison.run(world["tcfg"], world["tm"], world["tp"], steps=2,
                                   device="cpu")
    lines = buf.getvalue().splitlines()
    assert lines[0].split() == ["method", "trainable%", "acc", "loss", "opt", "state",
                                "samp/s"]
    assert lines[1].startswith("neuroada(k=1)") and lines[1].rstrip().endswith(
        f"{rows[0]['samples_per_s']:>7.1f}".strip())
    assert [r["tag"] for r in rows] == ["neuroada(k=1)"]
