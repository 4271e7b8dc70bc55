"""Deterministic synthetic fine-tuning tasks (CPU-scale stand-ins for the
paper's COMMONSENSE15K / GSM8K protocols) + a generic LM stream.

The port's own copy of ``repro.data.synthetic`` (numpy only): the same
seed and step give the same batches in both packages.

Every task is a pure function of (seed, step) so restarts resume the exact
stream (fault tolerance) and hosts shard by slicing the global batch.
"""

from __future__ import annotations

import numpy as np

VOCAB_RESERVED = 16  # 0=pad 1=bos 2=eos 3=sep 4=answer-marker …


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def lm_stream(vocab: int, batch: int, seq: int, seed: int, step: int) -> dict:
    """Zipf-distributed token stream (generic LM pretraining stand-in)."""
    r = _rng(seed, step)
    ranks = np.arange(1, vocab - VOCAB_RESERVED + 1)
    probs = 1.0 / ranks**1.2
    probs /= probs.sum()
    toks = r.choice(len(ranks), size=(batch, seq), p=probs) + VOCAB_RESERVED
    return {"tokens": toks.astype(np.int32), "targets": toks.astype(np.int32)}


def reasoning_task(
    vocab: int, batch: int, seq: int, seed: int, step: int, *, n_classes: int = 8
) -> dict:
    """COMMONSENSE15K stand-in: a context pattern deterministically selects
    an answer class; the model must learn the (fixed random) mapping.

    Layout per row: [bos, ctx …, sep, answer, eos, pad …]; loss only on the
    answer position (the paper's multi-token classification, reduced).

    The pattern→answer mapping is a property of the TASK (fixed constant
    seed), not of the data stream: train/eval loaders with different seeds
    draw different examples of the SAME task.
    """
    r_map = _rng(1234, 0)  # task mapping: fixed across streams and steps
    n_pat = 64
    answer_of = r_map.integers(0, n_classes, size=n_pat)
    r = _rng(seed, step + 1)
    ctx_len = min(seq - 4, 12)
    pat = r.integers(0, n_pat, size=(batch,))
    base = VOCAB_RESERVED + n_classes
    toks = np.zeros((batch, seq), np.int64)
    mask = np.zeros((batch, seq), np.float32)
    toks[:, 0] = 1  # bos
    # context tokens encode the pattern id in unary-ish chunks + noise
    for i in range(ctx_len):
        noise = r.integers(0, 32, size=(batch,))
        toks[:, 1 + i] = base + (pat * 31 + i * 7 + noise * 0) % 4096 % (
            min(4096, vocab - base)
        )
    toks[:, 1 + ctx_len] = 3  # sep
    ans_pos = 2 + ctx_len
    toks[:, ans_pos] = VOCAB_RESERVED + answer_of[pat]
    toks[:, ans_pos + 1] = 2  # eos
    # mark the TARGET position: after the [:,1:] slice in the loss, column
    # ans_pos lands at index ans_pos-1 = logits position predicting it.
    mask[:, ans_pos] = 1.0
    return {
        "tokens": toks.astype(np.int32),
        "targets": toks.astype(np.int32),
        "loss_mask": mask[:, 1:],  # aligned with targets[:,1:]
        "answer_pos": np.full((batch,), ans_pos, np.int32),
        "answer": toks[:, ans_pos].astype(np.int32),
    }


def arithmetic_task(vocab: int, batch: int, seq: int, seed: int, step: int) -> dict:
    """GSM8K stand-in: 'a + b = c' in digit tokens, multi-digit carry.

    Digits are tokens VOCAB_RESERVED+0..9; '+' -> 3(sep), '=' -> 4.
    Loss on the answer digits.
    """
    r = _rng(seed, step + 1)
    d0 = VOCAB_RESERVED
    a = r.integers(0, 100, size=(batch,))
    b = r.integers(0, 100, size=(batch,))
    c = a + b
    toks = np.zeros((batch, seq), np.int64)
    mask = np.zeros((batch, seq), np.float32)
    for i in range(batch):
        row = [1]  # bos
        row += [d0 + int(ch) for ch in str(a[i])]
        row += [3]
        row += [d0 + int(ch) for ch in str(b[i])]
        row += [4]
        ans_start = len(row)
        row += [d0 + int(ch) for ch in str(c[i])]
        row += [2]  # eos
        row = row[: seq]
        toks[i, : len(row)] = row
        mask[i, ans_start : len(row)] = 1.0  # target positions (answer+eos)
    return {
        "tokens": toks.astype(np.int32),
        "targets": toks.astype(np.int32),
        "loss_mask": mask[:, 1:],
    }


TASKS = {
    "lm": lm_stream,
    "reasoning": reasoning_task,
    "arithmetic": arithmetic_task,
}
