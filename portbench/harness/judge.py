"""How ``correct`` is decided: the numbers that compare what the timed
path produced with the plain reference, each against its limit in
``portbench/limits/<workload>.json``.

Training (the first ``checked_steps`` steps, which set-up drives through
the window's own call):

- ``selection_mismatch``: selected indices that differ from the
  reference's magnitude selection (exact: limit 0);
- ``loss_gap``: the widest |loss - reference| / reference over the steps;
- ``grad_gap``: over leaves (one a layer's adapted matrix), the widest
  |norm - reference norm| of the first clipped gradient, as the optimizer
  got it, over the larger of the leaf's reference norm and the median
  leaf's;
- ``change_gap``: the same of the values' change after the checked steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (others move under AdamW by round-off alone).
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np

from portbench.reference import train as ref_train

LIMITS = Path(__file__).resolve().parent.parent / "limits"


def limits_of(workload: str) -> dict:
    return json.loads((LIMITS / f"{workload}.json").read_text())


def _leaf_gap(got: dict, want: dict, keep=None) -> float:
    names = [n for n in want if keep is None or n in keep]
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def train_numbers(got: dict, want: dict) -> dict:
    sel = sum(int((got["indices"][p].long().cpu() != want["indices"][p].long().cpu()).sum())
              for p in want["indices"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    med = statistics.median(want["grad"].values())
    moving = {n for n, g in want["grad"].items() if g >= 1e-3 * med}
    return {"selection_mismatch": float(sel), "loss_gap": loss,
            "grad_gap": _leaf_gap(got["grad"], want["grad"]),
            "change_gap": _leaf_gap(got["change"], want["change"], moving)}


def train_reference(rec, **kw) -> dict:
    mix = rec.mix
    return ref_train.steps(rec.arch, rec.inputs["params"], rec.inputs["batches"],
                           mix["optimizer"], k=mix["peft"]["k"],
                           n_steps=mix["checked_steps"], **kw)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is not finite fails. A limit of null marks a number
    that is read and printed but not compared (PERF.md says why)."""
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    held = {n: v for n, v in numbers.items() if limits[n] is not None}
    ok = bool(held) and all(np.isfinite(v) and v <= limits[n] for n, v in held.items())
    return ok, checks
