"""Shared helpers of the examples (twins of ``bench_model`` and
``train_and_eval`` in the reference's ``benchmarks/common.py``): a reduced
model with seeded weights, and one PEFT method's fine-tune and held-out
accuracy with its memory figures."""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import PeftConfig, TrainConfig, get_config, reduced
from repro_torch.data import DataLoader, peek_batch
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.peft import get_peft, stats
from repro_torch.quant import tree_bytes
from repro_torch.train import Trainer


def bench_model(arch="qwen2-1.5b", *, device=None, **cfg_kw):
    """(cfg, model, params) of reduced ``arch``; params from seed 0 on
    ``device`` (default ``cuda``)."""
    cfg = reduced(get_config(arch))
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)
    m = get_model(cfg)
    params = m.init(seed=0, device=resolve_device(device))
    return cfg, m, params


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_and_eval(
    cfg, m, params, method: str, *, k=1, lora_rank=4, steps=120, lr=3e-3,
    task="reasoning", batch=16, seq=32, seed=11, device=None,
) -> dict:
    """Fine-tune with one PEFT method; return accuracy + memory stats.
    ``params`` live on ``device`` (default ``cuda``); ``samples_per_s`` is
    the wall time of the steps, the device drained at both ends."""
    dev = resolve_device(device)
    peft = get_peft(PeftConfig(method=method, k=k, lora_rank=lora_rank))
    tcfg = TrainConfig(learning_rate=lr, steps=steps, log_every=0, checkpoint_every=0)
    tr = Trainer(m, peft, tcfg, params)
    st = stats(params, tr.state.trainable)
    opt_bytes = tree_bytes({"mu": tr.state.opt_state.mu, "nu": tr.state.opt_state.nu})
    grad_bytes = tree_bytes(tr.state.trainable)
    data = DataLoader(task, cfg.vocab_size, batch, seq, seed=seed)
    synchronize(dev)
    t0 = time.perf_counter()
    hist = tr.run(data, steps=steps)
    synchronize(dev)
    wall = time.perf_counter() - t0
    data.close()

    test = peek_batch(task, cfg.vocab_size, 128, seq, seed=9999)
    eff, ad = peft.model_inputs(params, tr.state.trainable, tr.aux)
    with torch.no_grad():
        logits, _ = m.forward_train(eff, ad, {kk: torch.as_tensor(v).to(dev)
                                              for kk, v in test.items()})
    if "answer_pos" in test:
        pp = int(test["answer_pos"][0]) - 1
        preds = logits[:, pp, : cfg.vocab_size].float().argmax(-1).cpu().numpy()
        acc = float(np.mean(preds == test["answer"]))
    else:  # token accuracy on masked positions
        preds = logits[:, :-1, : cfg.vocab_size].float().argmax(-1).cpu().numpy()
        tgt = test["targets"][:, 1:]
        mask = test.get("loss_mask", np.ones_like(tgt, np.float32))
        acc = float((preds == tgt)[mask > 0].mean())
    return {
        "method": method,
        "fraction": st["fraction"],
        "acc": acc,
        "final_loss": float(np.mean([h["loss"] for h in hist[-5:]])),
        "opt_state_bytes": int(opt_bytes),
        "trainable_bytes": int(grad_bytes),
        "samples_per_s": steps * batch / wall,
        "us_per_step": wall / steps * 1e6,
    }
