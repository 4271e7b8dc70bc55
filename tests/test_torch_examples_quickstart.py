"""The port's quickstart twin against the reference's quickstart on the CPU.

``reference_quickstart`` repeats the calls of the reference's
``examples/quickstart.py`` (lines 36-95) line for line, at a chosen step
count; ``repro_torch.examples.quickstart.run`` is the twin. Both start from
the reference's reduced qwen2-1.5b params (``PRNGKey(0)``), the twin's
converted leaf by leaf, with the model in float32 (the examples' bf16
model differs between XLA's and PyTorch's roundings; every parity test of
the port holds float32), 8 steps, on the fp32 base and on an int8 base
that each package's ``quantize_base`` packs from the same dense params
(``test_torch_examples_quickstart_int8.py``, which imports this file's
helpers).

Held: the trainable and total counts exactly, the losses step by step
within 1e-5 relative, the answer accuracy, the merged engine's greedy
tokens and the int8 self-drafted engine's tokens with its accepted,
drafted and emitted counts, and the requests finished and transfers. The
twin serves on the port's paged engine (its default), the reference on
its dense one (the reference engine's default): greedy tokens agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PeftConfig as JPeftConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config, reduced
from repro.data.loader import DataLoader as JLoader
from repro.data.loader import peek_batch as j_peek_batch
from repro.models import get_model as j_get_model
from repro.peft import get_peft as j_get_peft
from repro.peft import quantize_base as j_quantize_base
from repro.peft import stats as j_stats
from repro.quant import tree_bytes as j_tree_bytes
from repro.serve.engine import ServeEngine as JEngine
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import tree_to_torch
from repro_torch.examples import quickstart
from repro_torch.kernels import COUNTERS, reset_counters

torch.set_num_threads(2)
STEPS = 8
NONE = lambda x: x is None  # noqa: E731


def np_tree(tree):
    return jax.tree.map(lambda x: None if x is None else np.asarray(x), tree, is_leaf=NONE)


@pytest.fixture(scope="module")
def world():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jp = j_get_model(cfg).init(jax.random.PRNGKey(0))
    tcfg = t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32")
    return {"cfg": cfg, "jp": jp, "tcfg": tcfg, "tp": tree_to_torch(np_tree(jp))}


def reference_quickstart(cfg, params, base_dtype: str, steps: int) -> dict:
    """The reference's ``examples/quickstart.py:36-95`` at ``steps`` steps
    (its ``model.init`` replaced by the given ``params``), returning what
    the twin's ``run`` returns."""
    model = j_get_model(cfg)  # :35
    out = {}
    if base_dtype != "fp32":  # :37-41
        dense_bytes = j_tree_bytes(params)
        params = j_quantize_base(params, base_dtype)
        out.update(dense_bytes=dense_bytes, packed_bytes=j_tree_bytes(params))
    peft = j_get_peft(JPeftConfig(method="neuroada", k=2, strategy="magnitude"))  # :44
    tcfg = JTrainConfig(learning_rate=5e-3, steps=steps, log_every=40)  # :45
    trainer = JTrainer(model, peft, tcfg, params)  # :46
    st = j_stats(params, trainer.state.trainable)  # :47
    out.update(trainable=st["trainable"], total=st["total"], fraction=st["fraction"])
    data = JLoader("reasoning", cfg.vocab_size, 32, 32, seed=0)  # :51
    hist = trainer.run(data, steps=steps)  # :52
    data.close()
    out["losses"] = [h["loss"] for h in hist]
    test = j_peek_batch("reasoning", cfg.vocab_size, 128, 32, seed=777)  # :57
    eff, adapters = peft.model_inputs(params, trainer.state.trainable, trainer.aux)  # :58
    logits, _ = model.forward(eff, adapters, {k: jnp.asarray(v) for k, v in test.items()})
    pp = int(test["answer_pos"][0]) - 1  # :60-62
    pred = np.argmax(np.asarray(logits[:, pp, : cfg.vocab_size], np.float32), -1)
    out["accuracy"] = float(np.mean(pred == test["answer"]))
    merged = trainer.merged_params()  # :72
    engine = JEngine(model, merged, slots=2, max_len=64, metrics=True)  # :73-75
    engine.submit([1, 17, 25], max_new=8)
    engine.submit([1, 40, 41, 42], max_new=8)
    out["outs"] = {req.rid: list(req.out) for req in engine.run_to_completion()}  # :76
    snap = engine.metrics.snapshot()  # :78-80
    out.update(finished=int(snap["serve_requests_finished_total"]["series"][0]["value"]),
               transfers=int(engine.metrics.value("serve_transfers_total")))
    spec = JEngine(model, merged, slots=2, max_len=64, decode_chunk=8,  # :88-91
                   draft="int8", spec_k=4)
    spec.submit([1, 17, 25], max_new=8)
    spec.submit([1, 40, 41, 42], max_new=8)
    out["spec_outs"] = {req.rid: list(req.out) for req in spec.run_to_completion()}
    out.update(spec_accepted=spec.spec_accepted, spec_drafted=spec.spec_drafted,  # :94-95
               spec_emitted=spec.spec_emitted)
    return out


def check_twin(world, base):
    """The whole comparison (module doc) on one base."""
    want = reference_quickstart(world["cfg"], world["jp"], base, STEPS)
    reset_counters()
    got = quickstart.run(world["tcfg"], world["tp"], base_dtype=base, steps=STEPS,
                         device="cpu")
    for key in ("trainable", "total", "finished", "transfers", "spec_accepted",
                "spec_drafted", "spec_emitted", "outs", "spec_outs", "accuracy"):
        assert got[key] == want[key], key
    assert got["fraction"] == pytest.approx(want["fraction"], rel=1e-12)
    if base != "fp32":
        assert (got["dense_bytes"], got["packed_bytes"]) == (want["dense_bytes"],
                                                             want["packed_bytes"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert len(got["losses"]) == STEPS
    # one transfer a step on both engines; the drafted tokens are the plain ones
    assert got["transfers"] == got["steps"] and got["spec_transfers"] == got["spec_steps"]
    assert got["spec_outs"] == got["outs"]
    # the path of the card's run, each kernel's plain version here
    linear = "fused_linear_q" if base != "fp32" else "fused_linear"
    for name in ("topk_select", linear, "sparse_delta_dval", "paged_prefill_attention",
                 "paged_decode_attention", "decode_attention"):
        assert COUNTERS[name].plain > 0, name
    assert COUNTERS["fused_linear_q"].plain > 0  # the int8 drafter
    assert all(c.kernel == 0 for c in COUNTERS.values())


def test_quickstart_twin_matches_reference(world):
    check_twin(world, "fp32")
