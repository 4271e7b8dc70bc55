"""The training window's useful flops (frozen weights: forward and input
gradient, causal attention forward and backward, no recomputation) over
its seconds, as a share of the H100's 989 TFLOP/s in bf16."""

from portbench.harness import roofline

LAYER = "model step (models/transformer.py, moe.py, layers.py, attention.py)"
UNIT, SOURCE, MOVES, BETTER = "%", "host_clock", "train_tok_s", "higher"


def read(rec):
    if rec.kind != "train" or not rec.step_s:
        return None
    flops = len(rec.step_s) * roofline.train_step_flops(rec.arch, rec.mix["batch"], rec.mix["seq"])
    return 100.0 * flops / rec.window_s / roofline.PEAK_BF16
