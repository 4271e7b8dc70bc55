"""``correct`` must come out false when the timed path is broken: the run
is driven on the CPU at a tiny size (the look for a chip skipped), with a
fault planted in the program underneath, and judged by limits set as the
cells' are (between the sound runs' readings and the faults'). The
control, the reference in float8 in the program's place, must fail too."""

import time

import pytest
import torch

from portbench.harness import judge, manifest, traffic, weights
from portbench.harness.run_record import RunRecord
from portbench.tests.tiny import DENSE, MOE

# the tiny cells' sound readings stay under 2e-3 (values in bf16); the
# faults and the control read 2e-2 and more
TRAIN_LIMITS = {"selection_mismatch": 0, "loss_gap": 1e-4, "grad_gap": 8e-3, "change_gap": 8e-3}


def _train_mix():
    return dict(manifest.mix_of("train.b16s512"), batch=2, seq=16, max_steps_per_s=2000)


def _run(arch, mix, limits, monkeypatch, seconds):
    from portbench import run

    monkeypatch.setattr(judge, "limits_of", lambda name: limits)
    cell = manifest.Cell("tiny", 1, arch, mix, [], [])
    return run.execute(cell, 2**31 + 99, seconds, False, torch.device("cpu"), time.perf_counter())


def _unchanged(monkeypatch):
    from repro_torch.train import Trainer

    orig = Trainer.step

    def step(self, batch):
        old = self.state
        m = orig(self, batch)
        self.state = old
        return m

    monkeypatch.setattr(Trainer, "step", step)


def _half_batch(monkeypatch):
    from repro_torch.train import Trainer

    orig = Trainer.step
    monkeypatch.setattr(Trainer, "step", lambda self, b: orig(
        self, {k: v[: v.shape[0] // 2] for k, v in b.items()}))


@pytest.mark.parametrize("arch", [DENSE, MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch], ids=["sound", "unchanged",
                                                                         "half_batch"])
def test_train_faults(fault, arch, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    out = _run(arch, _train_mix(), TRAIN_LIMITS, monkeypatch, 0.1)
    assert out["correct"] is (fault is None), out["checks"]


def test_control_fails():
    mix = _train_mix()
    rec = RunRecord("train", DENSE, mix, 5, (0, 0), 0, 0, 0)
    rec.inputs = {"params": weights.make_params(DENSE, 5, torch.device("cpu")),
                  "batches": traffic.train_batches(mix, DENSE.vocab, 5, 3)}
    want = judge.train_reference(rec)
    numbers = judge.train_numbers(judge.train_reference(rec, precision="fp8"), want)
    assert judge.judge(numbers, TRAIN_LIMITS)[0] is False
    assert judge.judge(judge.train_numbers(want, want), TRAIN_LIMITS)[0] is True
