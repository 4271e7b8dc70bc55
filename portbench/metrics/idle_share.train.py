"""Share of the training window in which the device ran no operation (the
union of the traced operations' intervals, against the window)."""

from portbench.harness import devtrace

LAYER = "device (the H100)"
UNIT, SOURCE, MOVES, BETTER = "%", "device_trace", "train_tok_s", "lower"


def read(rec):
    ops = rec.ops()
    if rec.kind != "train" or ops is None:
        return None
    return 100.0 * (1.0 - devtrace.busy_seconds(ops) / rec.window_s)
