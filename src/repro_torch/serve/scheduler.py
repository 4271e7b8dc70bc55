"""Request admission, slot assignment and chunk planning for serving.

Host-side bookkeeping only — no jax. Requests queue in submit order; every
admission round pops as many as there are free slots. Each request carries
its tenant's ``adapter_id`` (0 = base model) and its own sampling
temperature, both threaded into the jitted decode step as traced arrays.

Admission no longer prefills (DESIGN §11): an admitted request enters its
slot with ``prefilled = 0`` and a ``prefill_target`` of the full
re-prefill basis ``prompt + out`` (out is empty on first entry; a
preempted request resumes over everything it already generated). The
engine's mixed chunk step then consumes the prompt ``prefill_chunk``
tokens at a time — :meth:`chunk_plan` carves the next step's (slots, C)
token buffer under the per-step token budget, decode slots riding along
as degenerate one-token chunks.

The paged engine adds two block-aware motions: admission takes a
``try_place`` callback so a request only leaves the queue when the block
pool can hold its prompt (head-of-line FIFO: the first refusal stops the
round), and :meth:`preempt` hands an admitted request back to the *front*
of the queue when decode or mid-prefill reservation runs out of blocks —
its prefill progress resets and it re-prefills later over ``prompt +
out``, continuing exactly where it stopped.

Production lifecycle (DESIGN §16) adds three intake guards and a
fairness policy:

* **bounded queue** — ``queue_limit`` caps the backlog; a submit against
  a full queue raises :class:`QueueFullError` (the front end turns it
  into HTTP 503 + Retry-After) instead of growing without bound;
* **token-bucket rate limits** — :meth:`set_rate_limit` arms a
  per-tenant ``(rate, burst)`` bucket refilled on the shared monotonic
  clock; an empty bucket raises :class:`RateLimitedError` carrying the
  exact ``retry_after`` until the next token;
* **deficit-weighted admission** (``policy="drr"``) — per-tenant FIFO
  order is preserved, but tenants take turns in id-rotation order, each
  accumulating ``quantum`` tokens of deficit per visit and admitting
  while the deficit covers the head request's cost (``prompt +
  max_new`` tokens). A hot tenant flooding the queue can therefore
  delay another tenant's head by at most one rotation — about
  ``quantum / cost`` of its own requests — instead of its whole
  backlog. ``policy="fifo"`` (the default) is the original global
  arrival order.

Terminal state also lives here: :attr:`Request.reason` records how a
request ended (``eos`` | ``max_new`` | ``cache_full`` | ``cancelled`` |
``deadline``), :attr:`Request.deadline` the absolute clock reading after
which the engine's boundary sweep evicts it, and :meth:`remove_queued` /
:meth:`get` give the engine O(1)-ish handles on any in-flight request
for mid-queue cancellation.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

import repro_torch.obs.clock as _clock

#: admission policies: global arrival order vs per-tenant deficit rounds
POLICIES = ("fifo", "drr")

#: terminal reasons a request can report (DESIGN §16 state machine)
TERMINAL_REASONS = ("eos", "max_new", "cache_full", "cancelled", "deadline")


class QueueFullError(RuntimeError):
    """Bounded admission queue is at ``queue_limit``: shed the request
    (HTTP 503 + Retry-After at the front end) instead of queueing it."""

    def __init__(
        self,
        depth: int,
        limit: int | None,
        retry_after: float = 1.0,
        reason: str | None = None,
    ):
        super().__init__(
            reason
            if reason is not None
            else f"admission queue full ({depth}/{limit}); retry later"
        )
        self.depth = depth
        self.limit = limit
        self.retry_after = retry_after
        self.reason = reason


class RateLimitedError(RuntimeError):
    """Tenant token bucket is empty; ``retry_after`` is the exact time
    until the next token accrues (HTTP 429 + Retry-After)."""

    def __init__(self, adapter_id: int, retry_after: float):
        super().__init__(
            f"tenant {adapter_id} rate-limited; retry in {retry_after:.3f}s"
        )
        self.retry_after = retry_after


class _TokenBucket:
    """Classic token bucket on the injected monotonic clock: ``rate``
    tokens/second accrue up to ``burst``; each submit costs one."""

    def __init__(self, rate: float, burst: float, clock):
        if rate <= 0 or burst <= 0:
            raise ValueError(
                f"rate and burst must be > 0, got rate={rate} burst={burst}"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._t) * self.rate
        )
        self._t = now

    def try_take(self) -> float | None:
        """Take one token; None on success, else seconds until one accrues."""
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return None
        return (1.0 - self._tokens) / self.rate


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    adapter_id: int = 0
    temperature: float = 0.0
    # AdapterStore.removals at submit: adapter_id is only meaningful
    # against that revision of the store (remove() shifts later ids)
    store_rev: int = 0
    out: list[int] = field(default_factory=list)
    done: bool = False
    # lifecycle terminal state (DESIGN §16): how the request ended —
    # "eos" | "max_new" | "cache_full" | "cancelled" | "deadline" — and
    # the cancellation flag the engine flips before reclaiming the slot.
    reason: str | None = None
    cancelled: bool = False
    # absolute deadline on the shared monotonic clock (None = none): the
    # engine's boundary sweep evicts queued AND in-flight requests whose
    # deadline has passed, with full slot/page reclamation.
    deadline: float | None = None
    # observability stamps on the SAME monotonic clock the tracer reads
    # (repro.obs.clock, DESIGN §16): submission time — the TTFT baseline —
    # and the arrival of the request's latest emitted token batch, from
    # which the engine derives inter-token latency.
    t_submit: float = 0.0
    t_last: float = 0.0
    # chunked-prefill progress: basis tokens (prompt + out-at-admission)
    # already written to KV, and the admission-time basis length. A slot
    # is mid-prefill while prefilled < prefill_target; the step the two
    # meet samples the request's next token (its *first* on fresh entry).
    prefilled: int = 0
    prefill_target: int = 0
    # speculative-decoding telemetry (draft != "off" engines only): raw
    # drafter proposals made for this request and how many the full model
    # accepted — len(out) is the emitted count, so acceptance rate and
    # drafted-vs-emitted both fall out without extra bookkeeping
    spec_drafted: int = 0
    spec_accepted: int = 0

    @property
    def mid_prefill(self) -> bool:
        return self.prefilled < self.prefill_target

    @property
    def cost(self) -> int:
        """Deficit-accounting weight: the tokens this request can consume
        (prompt prefill + decode budget) — what the DRR quantum is spent
        against."""
        return len(self.prompt) + self.max_new


class Scheduler:
    """Admission over a fixed set of decode slots: FIFO by default,
    per-tenant deficit-weighted round robin with ``policy="drr"``."""

    def __init__(
        self,
        slots: int,
        *,
        policy: str = "fifo",
        queue_limit: int | None = None,
        quantum: int = 256,
        clock=None,
    ):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.slots = slots
        self.policy = policy
        self.queue_limit = queue_limit
        self.quantum = quantum
        self.clock = clock if clock is not None else _clock.now
        self.active: list[Request | None] = [None] * slots
        self._queue: deque[Request] = deque()
        self._next_rid = 0
        self._by_rid: dict[int, Request] = {}  # every in-flight request
        # DRR state: per-tenant token deficits and the rotation cursor
        # (the tenant id the next round starts AFTER, so service resumes
        # where the last round left off instead of always favoring low ids)
        self._deficit: dict[int, float] = {}
        self._last_tenant: int | None = None
        # per-tenant token buckets (None = tenant unlimited)
        self._buckets: dict[int, _TokenBucket] = {}

    # -------------------------------------------------------------- intake

    def set_rate_limit(
        self, adapter_id: int, rate: float, burst: float | None = None
    ) -> None:
        """Arm (or replace) a tenant's token bucket: ``rate`` requests per
        second, up to ``burst`` banked (default: ``max(rate, 1)``)."""
        self._buckets[adapter_id] = _TokenBucket(
            rate, burst if burst is not None else max(rate, 1.0), self.clock
        )

    def clear_rate_limit(self, adapter_id: int) -> None:
        self._buckets.pop(adapter_id, None)

    def submit(
        self,
        prompt: list[int],
        max_new: int = 32,
        *,
        adapter_id: int = 0,
        temperature: float = 0.0,
        store_rev: int = 0,
        deadline: float | None = None,
    ) -> int:
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        # queue_limit first (it mutates nothing): a request shed for a
        # full queue must not also debit the tenant's token bucket, or
        # overload double-penalizes the tenant with 429s for requests
        # that were never queued
        if (
            self.queue_limit is not None
            and len(self._queue) >= self.queue_limit
        ):
            raise QueueFullError(len(self._queue), self.queue_limit)
        bucket = self._buckets.get(adapter_id)
        if bucket is not None:
            wait = bucket.try_take()
            if wait is not None:
                raise RateLimitedError(adapter_id, wait)
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid, list(prompt), max_new, adapter_id, temperature, store_rev,
            deadline=deadline,
        )
        req.t_submit = self.clock()
        self._queue.append(req)
        self._by_rid[rid] = req
        return rid

    # ------------------------------------------------------------- lookups

    def get(self, rid: int) -> Request | None:
        """The in-flight request with this rid (queued or admitted), or
        None once it has reached a terminal state."""
        return self._by_rid.get(rid)

    def slot_of(self, rid: int) -> int | None:
        for s, r in enumerate(self.active):
            if r is not None and r.rid == rid:
                return s
        return None

    def remove_queued(self, rid: int) -> Request | None:
        """Pull a still-queued request out of the backlog (mid-queue
        cancellation / deadline expiry) — admitted requests are not
        touched; evict those through the engine's slot reclamation."""
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                self._by_rid.pop(rid, None)
                return req
        return None

    def expired_queued(self, now: float) -> list[Request]:
        """Pull every queued request whose deadline has passed (the
        engine terminates them with reason="deadline")."""
        dead = [
            r for r in self._queue
            if r.deadline is not None and now >= r.deadline
        ]
        for req in dead:
            self._queue.remove(req)
            self._by_rid.pop(req.rid, None)
        return dead

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot (the admission backlog gauge)."""
        return len(self._queue)

    # ----------------------------------------------------------- admission

    def admissible(self, try_place=None) -> list[tuple[int, Request]]:
        """Pop queued requests into free slots; returns (slot, req).

        ``try_place(slot, req) -> bool`` (paged engine) reserves memory for
        the request; a False puts the request back at the queue head and
        ends the round — admitting around it would starve the head forever.
        Admission stamps the chunked-prefill basis before placement: the
        request re-enters with zero progress and a target of ``len(prompt
        + out)`` (the last basis token is consumed as prefill input and
        samples the next); ``try_place`` may then advance ``prefilled``
        past a shared prefix whose pages are already resident.

        ``policy="fifo"`` serves global arrival order; ``policy="drr"``
        serves per-tenant FIFO order under deficit round robin (the
        docstring at the top of this module states the starvation bound).
        """
        if self.policy == "drr":
            return self._admissible_drr(try_place)
        out = []
        for slot in range(self.slots):
            if self.active[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            if not self._place(slot, req, try_place):
                break
            out.append((slot, req))
        return out

    def _place(self, slot: int, req: Request, try_place) -> bool:
        """Stamp the prefill basis and seat ``req`` in ``slot``; on a
        try_place refusal the request returns to the queue head and the
        admission round ends (False)."""
        req.prefilled = 0
        req.prefill_target = len(req.prompt) + len(req.out)
        if try_place is not None and not try_place(slot, req):
            self._queue.appendleft(req)
            return False
        self.active[slot] = req
        return True

    def _admissible_drr(self, try_place) -> list[tuple[int, Request]]:
        """One deficit-round-robin admission round (DESIGN §16).

        Tenants with backlog are visited in id order starting after the
        last tenant served; each visit banks ``quantum`` deficit tokens
        and admits that tenant's queue head(s) while the deficit covers
        their cost. Unused deficit persists across rounds (a tenant with
        one huge request accumulates until it fits); a tenant whose
        backlog empties forfeits its deficit — the classic DRR rule that
        stops idle tenants from banking unbounded credit.
        """
        out = []
        # drop deficits of tenants with no backlog (forfeit on empty) —
        # BEFORE the early return, so a drained tenant loses its bank the
        # round its queue empties, not whenever it next submits
        backlog = {r.adapter_id for r in self._queue}
        for t in list(self._deficit):
            if t not in backlog:
                del self._deficit[t]
        free = deque(
            s for s in range(self.slots) if self.active[s] is None
        )
        if not free or not self._queue:
            return out
        tenants = sorted(backlog)
        # rotate: the round starts with the tenant AFTER the last served
        if self._last_tenant is not None:
            i = np.searchsorted(tenants, self._last_tenant, side="right")
            tenants = tenants[i:] + tenants[:i]
        for t in tenants:
            if not free:
                break
            self._deficit[t] = self._deficit.get(t, 0.0) + self.quantum
            while free:
                head = next(
                    (r for r in self._queue if r.adapter_id == t), None
                )
                if head is None or self._deficit[t] < head.cost:
                    break
                self._queue.remove(head)
                slot = free.popleft()
                if not self._place(slot, head, try_place):
                    # _place appendleft'ed it to the global head; the
                    # pool refused, so the whole round ends (the retry
                    # next step finds it first — no starvation around it)
                    self._last_tenant = t
                    return out
                self._deficit[t] -= head.cost
                self._last_tenant = t
                out.append((slot, head))
        return out

    def preempt(self, slot: int) -> Request:
        """Evict an admitted request back to the queue *front* (it is older
        than everything queued — rids are monotone) for later re-prefill.
        Mid-prefill victims lose their progress with their pages: the next
        admission restarts the chunk walk from token zero."""
        req = self.active[slot]
        self.active[slot] = None
        req.prefilled = 0
        self._queue.appendleft(req)
        return req

    def youngest_active(self) -> int | None:
        """Slot of the most recently submitted admitted request — the
        preemption victim (its re-prefill redoes the least work)."""
        slots = [s for s, r in enumerate(self.active) if r is not None]
        if not slots:
            return None
        return max(slots, key=lambda s: self.active[s].rid)

    def has_prefilling(self) -> bool:
        """True while any admitted request still owes prompt chunks — the
        engine then runs the mixed chunk step instead of the decode
        megastep."""
        return any(r is not None and r.mid_prefill for r in self.active)

    def chunk_plan(self, budget: int, kv_pos) -> dict[str, np.ndarray]:
        """Carve the next mixed step's (slots, budget) token buffer.

        Prefilling slots consume their next basis chunk — oldest request
        (lowest rid) first, total prefill tokens capped at ``budget`` per
        step (bounded per-step latency: a step is never longer than budget
        prefill tokens + one decode token per decode slot). Decode slots
        carry their last sampled token as a one-token chunk at their
        current cache position ``kv_pos``. ``emit`` marks the slots that
        sample a real token this step: every decode slot, plus prefill
        slots whose basis completes within the chunk. Stalled prefill
        slots (budget exhausted) and empty slots ride along as ``q_len =
        0`` no-ops whose position freezes at ``q_offset``.
        """
        n = self.slots
        plan = {
            "tokens": np.zeros((n, budget), np.int32),
            "q_offset": np.zeros((n,), np.int32),
            "q_len": np.zeros((n,), np.int32),
            "last_idx": np.zeros((n,), np.int32),
            "aid": np.zeros((n,), np.int32),
            "temps": np.zeros((n,), np.float32),
            "emit": np.zeros((n,), np.bool_),
        }
        left = budget
        order = sorted(
            (s for s, r in enumerate(self.active) if r is not None),
            key=lambda s: self.active[s].rid,
        )
        for s in order:
            req = self.active[s]
            plan["aid"][s] = req.adapter_id
            plan["temps"][s] = req.temperature
            if req.mid_prefill:
                take = min(req.prefill_target - req.prefilled, left)
                plan["q_offset"][s] = req.prefilled
                if take == 0:
                    continue  # budget exhausted: frozen no-op this step
                basis = req.prompt + req.out
                plan["tokens"][s, :take] = basis[
                    req.prefilled : req.prefilled + take
                ]
                plan["q_len"][s] = take
                plan["last_idx"][s] = take - 1
                plan["emit"][s] = req.prefilled + take == req.prefill_target
                left -= take
            else:
                plan["tokens"][s, 0] = req.out[-1]
                plan["q_offset"][s] = int(kv_pos[s])
                plan["q_len"][s] = 1
                plan["emit"][s] = True
        return plan

    def slot_arrays(self) -> dict[str, np.ndarray]:
        """Per-slot state as dense arrays for the decode megastep.

        Empty slots are inactive no-ops: ``active`` gates every in-graph
        write (sampled token, position advance, max_new budget), so the
        compiled chunk loop needs no per-slot host branching.
        """
        n = self.slots
        state = {
            "tokens": np.zeros((n,), np.int32),
            "aid": np.zeros((n,), np.int32),
            "temps": np.zeros((n,), np.float32),
            "active": np.zeros((n,), np.bool_),
            "remaining": np.zeros((n,), np.int32),
        }
        for s, req in enumerate(self.active):
            if req is None:
                continue
            state["tokens"][s] = req.out[-1]
            state["aid"][s] = req.adapter_id
            state["temps"][s] = req.temperature
            state["active"][s] = True
            state["remaining"][s] = req.max_new - len(req.out)
        return state

    def complete(self, slot: int) -> None:
        req = self.active[slot]
        if req is not None:
            req.done = True
            self._by_rid.pop(req.rid, None)
        self.active[slot] = None

    def has_active(self) -> bool:
        return any(r is not None for r in self.active)

    def has_queued(self) -> bool:
        return bool(self._queue)

    def in_flight(self) -> list[Request]:
        """All unfinished requests — admitted slots AND the queue, in
        submit (rid) order. Admitted-but-unfinished requests must be part
        of this snapshot: ``run_to_completion`` returns it."""
        reqs = [r for r in self.active if r is not None] + list(self._queue)
        return sorted(reqs, key=lambda r: r.rid)
