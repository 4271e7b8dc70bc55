"""The paper's Alg. 1 end to end on the port (twin of ``tests/test_system.py``):
select → sparse-train → merge → serve on reduced qwen2-1.5b, on the CPU.

Both tests start from the reference's initial params (``repro``'s
``model.init(PRNGKey(0))``), converted through numpy by
``repro_torch.convert``, and train on the port's data loader, whose batches
equal the reference's. The accuracy test keeps the reference's threshold:
NeuroAda k = 2 must beat the base model's answer accuracy by more than 0.2.
"""

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data.loader import peek_batch as j_peek_batch
from repro.models import get_model as j_get_model
from repro_torch.configs import PeftConfig, TrainConfig, get_config, reduced
from repro_torch.convert import tree_to_torch
from repro_torch.data import DataLoader
from repro_torch.data.loader import peek_batch
from repro_torch.models import get_model
from repro_torch.peft import get_peft, stats
from repro_torch.serve import ServeEngine
from repro_torch.train import Trainer
from repro_torch.tree import flatten

torch.set_num_threads(2)


def reference_params():
    """The reference's initial params of reduced qwen2-1.5b as port tensors,
    with the port's model of the same config."""
    jcfg = j_reduced(j_get_config("qwen2-1.5b"))
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    host = jax.tree.map(lambda x: None if x is None else np.asarray(x), jparams,
                        is_leaf=lambda x: x is None)
    cfg = reduced(get_config("qwen2-1.5b"))
    return cfg, get_model(cfg), tree_to_torch(host, device="cpu")


def batch_on(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_full_neuroada_pipeline():
    cfg, m, params = reference_params()

    # phases 1 and 2: select, then sparse-train
    peft = get_peft(PeftConfig(method="neuroada", k=2))
    tcfg = TrainConfig(learning_rate=3e-3, steps=80, log_every=0, checkpoint_every=0)
    tr = Trainer(m, peft, tcfg, params)
    st = stats(params, tr.state.trainable)
    assert st["fraction"] < 0.06  # featherlight
    data = DataLoader("reasoning", cfg.vocab_size, 16, 32, seed=3)
    hist = tr.run(data, steps=80)
    data.close()
    assert hist[-1]["loss"] < hist[0]["loss"]

    # phase 3: merge, with no inference overhead and the same structure
    merged = tr.merged_params()
    assert [p for p, _ in flatten(merged)] == [p for p, _ in flatten(params)]

    # serve the merged model on the port's engine
    eng = ServeEngine(m, merged, slots=2, max_len=64, device="cpu")
    eng.submit([1, 20, 30], max_new=4)
    reqs = eng.run_to_completion()
    assert len(reqs[0].out) == 4
    assert eng.transfers == eng.steps and eng.kv.drained()

    # the adaptation moved the predictions away from the base model's
    batch = batch_on(peek_batch("reasoning", cfg.vocab_size, 4, 32))
    with torch.no_grad():
        lg_base, _ = m.forward_train(params, None, batch)
        lg_tuned, _ = m.forward_train(merged, None, batch)
    assert float((lg_base.float() - lg_tuned.float()).abs().max()) > 0.01


def test_adaptation_accuracy_on_task():
    """NeuroAda k = 2 reaches high answer accuracy on the synthetic
    commonsense-style task (Fig. 4's measurement at smoke scale)."""
    cfg, m, params = reference_params()
    peft = get_peft(PeftConfig(method="neuroada", k=2))
    tcfg = TrainConfig(learning_rate=5e-3, steps=150, log_every=0, checkpoint_every=0)
    tr = Trainer(m, peft, tcfg, params)
    data = DataLoader("reasoning", cfg.vocab_size, 32, 32, seed=4)
    tr.run(data, steps=150)
    data.close()

    eff, ad = peft.model_inputs(params, tr.state.trainable, tr.aux)
    test = peek_batch("reasoning", cfg.vocab_size, 64, 32, seed=999)
    j_test = j_peek_batch("reasoning", cfg.vocab_size, 64, 32, seed=999)
    assert sorted(test) == sorted(j_test)
    for key in test:  # the port's task data is the reference's
        np.testing.assert_array_equal(test[key], j_test[key])
    pred_pos = test["answer_pos"][0] - 1  # predicting the token at answer_pos
    with torch.no_grad():
        logits, _ = m.forward_train(eff, ad, batch_on(test))
        base_logits, _ = m.forward_train(params, None, batch_on(test))
    preds = logits[:, pred_pos, : cfg.vocab_size].float().argmax(-1).numpy()
    base = base_logits[:, pred_pos, : cfg.vocab_size].float().argmax(-1).numpy()
    acc = float(np.mean(preds == test["answer"]))
    base_acc = float(np.mean(base == test["answer"]))
    assert acc > base_acc + 0.2, (acc, base_acc)
