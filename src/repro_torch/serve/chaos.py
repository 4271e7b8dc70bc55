"""Seeded fault injection for the serving lifecycle (DESIGN §16; the port's
copy of ``repro.serve.chaos``: the same seed on the same scheduling
decisions gives the same injections in both packages).

Real traffic is messy: clients vanish mid-stream, deadlines expire in
bursts, the block pool runs hot, consumers stall. Each of those has a
recovery path in the engine — mid-queue/mid-prefill/mid-decode
cancellation, the boundary deadline sweep, preempt-on-OOM, the slow
client disconnect — and every one of them must leave the pool fully
reclaimed and the surviving streams byte-identical. :class:`ChaosMonkey`
exercises all of it *deterministically*: one ``random.Random(seed)``
drives every injection, decisions are made only at step boundaries (the
same host points where real cancels/deadlines land), and nothing reads
the wall clock, so a seeded chaos run replays exactly.

Taxonomy (each armed by its probability knob, all default off):

* **cancels** (``cancel_prob``) — pick one in-flight request (queued or
  admitted, uniformly over sorted rids) and ``engine.cancel(rid)`` it:
  mid-queue, mid-prefill and mid-decode cancellation all fall out of
  where the victim happens to be;
* **deadline storms** (``deadline_prob``) — stamp one in-flight
  request's ``deadline`` to *now*, so the very next boundary sweep
  evicts it through the deadline path (reason="deadline");
* **pool pressure** (``pressure_prob``, paged engines only) — steal a
  seeded fraction of the free list for ``pressure_hold`` steps, forcing
  reserve() shortfalls → preemption and admission refusals, then give
  the blocks back. The steal is clamped so at least ``max_pages`` free
  blocks remain: one active request must always be able to reserve its
  horizon (the engine's documented single-request guarantee);
* **slow clients** (``slow_client_prob``) — :meth:`stream_delay` hands
  the front end a seeded per-token pause, starving the per-request
  stream queue the way a stalled consumer would (the front end's
  bounded buffer then cancels the request).

The engine calls :meth:`on_step` at the top of every ``step()``; the
harness records what it injected in :attr:`injected` so tests can assert
the paths actually fired.
"""

from __future__ import annotations

import random

__all__ = ["ChaosMonkey"]


class ChaosMonkey:
    def __init__(
        self,
        seed: int = 0,
        *,
        cancel_prob: float = 0.0,
        deadline_prob: float = 0.0,
        pressure_prob: float = 0.0,
        pressure_frac: float = 0.75,
        pressure_hold: int = 2,
        slow_client_prob: float = 0.0,
        slow_client_delay: float = 0.05,
    ):
        for name, p in (
            ("cancel_prob", cancel_prob),
            ("deadline_prob", deadline_prob),
            ("pressure_prob", pressure_prob),
            ("slow_client_prob", slow_client_prob),
        ):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        if not 0.0 < pressure_frac <= 1.0:
            raise ValueError(
                f"pressure_frac must be in (0, 1], got {pressure_frac}"
            )
        if pressure_hold < 1:
            raise ValueError(
                f"pressure_hold must be >= 1, got {pressure_hold}"
            )
        self.rng = random.Random(seed)
        self.cancel_prob = cancel_prob
        self.deadline_prob = deadline_prob
        self.pressure_prob = pressure_prob
        self.pressure_frac = pressure_frac
        self.pressure_hold = pressure_hold
        self.slow_client_prob = slow_client_prob
        self.slow_client_delay = slow_client_delay
        self._pressure_left = 0  # steps the current steal has to run
        self.injected = {
            "cancel": 0, "deadline": 0, "pressure": 0, "slow_client": 0,
        }

    # ------------------------------------------------------ engine boundary

    def _victim(self, engine) -> int | None:
        """A uniformly chosen in-flight rid (sorted order: deterministic
        regardless of queue/slot layout), or None when idle."""
        rids = sorted(r.rid for r in engine.scheduler.in_flight())
        if not rids:
            return None
        return self.rng.choice(rids)

    def on_step(self, engine) -> None:
        """One injection round, called by the engine at the top of every
        ``step()`` — the exact boundary where real cancels, deadline
        expiries and allocation pressure land. Draw order is fixed
        (cancel, deadline, pressure) so a seed replays identically."""
        if not engine.scheduler.in_flight():
            self.release(engine)
            return
        if self.cancel_prob and self.rng.random() < self.cancel_prob:
            rid = self._victim(engine)
            if rid is not None and engine.cancel(rid):
                self.injected["cancel"] += 1
        if self.deadline_prob and self.rng.random() < self.deadline_prob:
            rid = self._victim(engine)
            if rid is not None:
                req = engine.scheduler.get(rid)
                if req is not None:
                    # storm: expires on the sweep this same step runs next
                    req.deadline = engine.clock()
                    self.injected["deadline"] += 1
        if engine.paged:
            self._pool_pressure(engine.kv)

    def release(self, engine) -> None:
        """Give any held steal back. The engine calls this the moment it
        discovers it is idle — including mid-``step()``, when this step's
        own injections just terminated the last request — so the post-run
        pool audit (``kv.drained()``) sees the full free list, never
        chaos's hostages."""
        if engine.paged and self._pressure_left:
            engine.kv.restore_blocks()
            self._pressure_left = 0

    def _pool_pressure(self, kv) -> None:
        if self._pressure_left > 0:
            self._pressure_left -= 1
            if self._pressure_left == 0:
                kv.restore_blocks()
            return
        if not self.pressure_prob or self.rng.random() >= self.pressure_prob:
            return
        # clamp: leave one full request's pages allocatable, always — the
        # engine preempts down to ONE active request under pressure and
        # that request's reserve() must succeed (its RuntimeError on a
        # pool that cannot hold a single request is a leak detector, and
        # chaos must never trip it spuriously)
        headroom = kv.free_blocks - kv.max_pages
        want = int(kv.free_blocks * self.pressure_frac)
        took = kv.steal_blocks(min(want, headroom))
        if took:
            self.injected["pressure"] += 1
            self._pressure_left = self.pressure_hold

    # ---------------------------------------------------- frontend boundary

    def stream_delay(self) -> float:
        """Per-token client-side stall the front end applies before
        draining a stream queue entry (seconds; 0 = healthy client)."""
        if (
            self.slow_client_prob
            and self.rng.random() < self.slow_client_prob
        ):
            self.injected["slow_client"] += 1
            return self.slow_client_delay
        return 0.0
