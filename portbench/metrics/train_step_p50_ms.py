"""Median host time of one ``Trainer.step`` in the window (each step ends
in the trainer's host read of its metrics, so it has finished)."""

import statistics

LAYER = "trainer (train/trainer.py, optim/adamw.py, peft/api.py)"
UNIT, SOURCE, MOVES, BETTER = "ms", "host_clock", "train_tok_s", "lower"


def read(rec):
    return statistics.median(rec.step_s) * 1e3 if rec.kind == "train" and rec.step_s else None
