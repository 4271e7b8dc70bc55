"""Fault-tolerance utilities: NaN guard, straggler monitor, restart policy.

The port's own copy of ``repro.distributed.fault`` (standard library only).

At 1000+ nodes the failure model is: (a) hardware loss → restart from the
latest atomic checkpoint with a possibly different device count (elastic —
checkpoints are device-agnostic numpy, re-sharded at load); (b) data-driven
divergence → NaN/inf step guard skips the update and counts; (c) stragglers
→ per-step wall-time EWMA, steps beyond ``threshold_sigma`` are flagged so
an external orchestrator can drain/replace the slow host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags outlier steps (>μ + kσ)."""

    alpha: float = 0.05
    threshold_sigma: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    count: int = 0
    flagged: list = field(default_factory=list)
    _t0: float | None = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Record the timed interval; True if this step is a straggler."""
        return self.observe(step, time.monotonic() - self._t0)

    def observe(self, step: int, dt: float) -> bool:
        """Record an explicit duration (testable without wall clocks)."""
        self.count += 1
        if self.count == 1:
            self.mean = dt
            return False
        # flag against the PRE-update statistics so an outlier cannot
        # inflate its own threshold…
        sigma = max(self.var**0.5, 1e-9)
        slow = dt > self.mean + self.threshold_sigma * sigma and self.count > 10
        if slow:
            self.flagged.append((step, dt))
            return True  # …and a flagged step never pollutes the EWMA
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return False


@dataclass
class NanGuard:
    """Counts skipped (non-finite) steps; trips after ``max_skipped``."""

    max_skipped: int = 50
    skipped: int = 0

    def record(self, skipped: bool) -> None:
        if skipped:
            self.skipped += 1
            if self.skipped > self.max_skipped:
                raise RuntimeError(
                    f"NaN guard tripped: {self.skipped} non-finite steps — "
                    "training is diverging; restore an earlier checkpoint "
                    "with a lower LR."
                )
