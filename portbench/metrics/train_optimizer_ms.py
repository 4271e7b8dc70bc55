"""Median over the window's steps of the device time of the step's optimizer
region (``train.optimizer``: ``post_grad``, the clip, AdamW,
``apply_updates`` and the NaN guard's selects). It comes from the
program's span events: CUDA timing events the trainer records at each
region's entry and exit while the device trace runs, put on the trace's
host clock after the window (``harness/progspans.py``). None where the
program records no regions."""

from portbench.harness import progspans

LAYER = "trainer (train/trainer.py, optim/adamw.py, peft/api.py)"
UNIT, SOURCE, MOVES, BETTER = "ms", "device_trace", "train_tok_s", "lower"


def read(rec):
    return progspans.step_ms(rec, "train.optimizer")
