"""The yardstick's arithmetic against counts by hand: useful flops, kernel
work, the device trace's reduction, and the training batches."""

import numpy as np
import pytest

from portbench.harness import arch as arch_lib
from portbench.harness import devtrace, manifest, roofline, traffic

QWEN2 = manifest.cell("qwen2-1.5b.train.b16s512").arch
OLMOE = manifest.cell("olmoe-1b-7b.train.b16s512").arch


def test_active_params_by_hand():
    # qwen2: q, o 1536x1536; k, v 1536x256; three 1536x8960 MLP matrices; 28 layers
    per = 2 * 1536 * 1536 + 2 * 1536 * 256 + 3 * 1536 * 8960
    assert roofline.active_params(QWEN2) == 28 * per
    # olmoe: 4 of 2048x2048, the router 2048x64, 8 of 64 experts' 3 x 2048x1024
    per = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert roofline.active_params(OLMOE) == 16 * per
    assert roofline.head_params(QWEN2) == 1536 * 151936


def test_train_step_flops_by_hand():
    t, pairs = 16 * 512, 16 * 512 * 513 / 2
    n = roofline.active_params(QWEN2) + 1536 * 151936
    want = 4 * n * t + 12 * 12 * 128 * 28 * pairs
    assert roofline.train_step_flops(QWEN2, 16, 512) == pytest.approx(want, rel=1e-12)
    assert 5.0e13 < want < 5.3e13


def test_kernel_work_by_hand():
    unique = {"k": 1, **{n: [100] * 28 for n in ("wq", "wk", "wv", "wo", "wgate", "wup",
                                                  "wdown")}}
    work = roofline.fused_linear_work(QWEN2, 8192, unique)
    assert len(work) == 7 * 28
    nbytes, flops = work[0]  # wq: x, W, y in bf16, idx int32 + val bf16, the bias
    assert nbytes == (8192 * 1536 + 1536 * 1536 + 8192 * 1536) * 2 + 1536 * 6 + 1536 * 2
    assert flops == 2 * 8192 * 1536 * 1537
    dval = roofline.dval_work(QWEN2, 8192, unique)
    assert len(dval) == 7 * 28
    assert dval[0] == ((8192 * 1536 + 8192 * 100) * 2 + 1536 * 6, 2 * 8192 * 1536)
    # olmoe's expert stacks: 32 groups of 256 tokens, 40 rows an expert a group
    assert roofline.expert_rows(OLMOE, 8192) == 32 * 40
    assert roofline.least_seconds(3.35e12, 0) == 1.0 and roofline.least_seconds(0, 989e12) == 1.0


def test_trace_reduction():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("a", 3.0, 4.0), ("c", 4.0, 4.5)]
    assert devtrace.busy_seconds(ops) == 3.5
    assert devtrace.by_name(ops)[0] == ["a", 2.0]
    gaps = devtrace.idle_gaps(ops, [("step", 2.5, 3.5)], 0.0, 5.0)
    assert gaps == [["step", 1.0], ["harness", 0.5]]
    assert devtrace.clip(ops, 0.75, 3.5) == [("a", 0.75, 1.0), ("b", 0.75, 2.0),
                                             ("a", 3.0, 3.5)]
    assert devtrace.time_of([("x_kernel<DenseW>", 0, 1), ("x_kernel<PackedW>", 0, 2)],
                            ("x_kernel", "!PackedW")) == 1
    assert roofline.roofline_share([], 1.0) is None


def test_batches_are_the_same_sizes_for_every_seed():
    mix = manifest.mix_of("train.b16s512")
    a = traffic.train_batches(mix, 512, 2**31 + 5, 2)
    b = traffic.train_batches(mix, 512, 11, 2)
    assert a[0]["tokens"].shape == b[0]["tokens"].shape == (16, 512)
    assert not np.array_equal(a[0]["tokens"], a[1]["tokens"])
    assert not np.array_equal(a[0]["tokens"], b[0]["tokens"])
    assert np.array_equal(a[1]["tokens"], traffic.train_batches(mix, 512, 2**31 + 5, 2)[1]["tokens"])
    assert a[0]["tokens"].min() >= mix["tokens"]["reserved"] and a[0]["tokens"].max() < 512
    rows = a[0]["tokens"]
    assert len({r.tobytes() for r in rows}) == len(rows)


def test_capacity_and_groups():
    assert arch_lib.num_groups(8192, 8) == 32 and arch_lib.capacity(OLMOE, 256) == 40
    assert arch_lib.num_groups(6, 8) == 1
