"""Median over the window's steps of the device time of the step's forward
regions (``train.forward``, one a microbatch: ``peft.model_inputs`` and
``model.loss``). It comes from the program's span events: CUDA timing
events the trainer records at each region's entry and exit while the
device trace runs, put on the trace's host clock after the window
(``harness/progspans.py``). None where the program records no regions."""

from portbench.harness import progspans

LAYER = "model step (models/transformer.py, moe.py, layers.py, attention.py)"
UNIT, SOURCE, MOVES, BETTER = "ms", "device_trace", "train_tok_s", "lower"


def read(rec):
    return progspans.step_ms(rec, "train.forward")
