"""The training backward's value gradients (``sparse_delta_dval``): the
least time of their work in the window over their device time by name."""

from portbench.harness import devtrace, roofline

LAYER = "kernels (kernels/ops.py, the wrappers, csrc/)"
UNIT, SOURCE, MOVES, BETTER = "%", "device_trace", "train_tok_s", "higher"


def read(rec):
    ops = rec.ops()
    if rec.kind != "train" or ops is None:
        return None
    m = rec.mix["microbatches"]
    work = roofline.dval_work(rec.arch, rec.mix["batch"] * rec.mix["seq"] // m,
                              rec.train["unique"])
    secs = devtrace.time_of(ops, roofline.KERNELS["sparse_delta_dval"])
    return roofline.roofline_share(work * (m * len(rec.step_s)), secs)
