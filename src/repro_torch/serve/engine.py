"""Multi-tenant serving engine (port of ``repro.serve.engine``, paged and
dense layouts).

One frozen base model serves every tenant: each step applies each slot's
NeuroAda ``(k, d_out)`` bypass in flight (``BatchedDelta``, the
``sparse_delta_batched`` kernel) instead of merging weights. With
``paged=True`` (the default here) the KV cache is the shared block pool of
:class:`~repro_torch.serve.kv_cache.PagedKVCache` with block-aware
admission, same-tenant prefix sharing and preemption of the youngest
request when the pool runs short; with ``paged=False`` it is the dense slot
cache of :class:`~repro_torch.serve.kv_cache.KVCache`, every slot holding
``max_len`` rows (admission needs only a free slot, nothing is preempted).
``kv_dtype="int8"`` stores either layout as int8 codes with float32 scales
(DESIGN §15); the attention kernels then run their int8 bodies.

While any admitted prompt owes chunks, a step is one *mixed* chunk step:
prefilling slots consume up to ``prefill_chunk`` prompt tokens in all,
decode slots advance one token, and every slot whose prompt completes
samples its first token. Otherwise a step is a *decode megastep* of up to
``decode_chunk`` tokens per slot, with sampling, EOS, budget and cache-full
masking on the device. Either way a step costs exactly one device-to-host
transfer (``transfers`` counts them): inside a step there is no ``.item()``,
no boolean-mask indexing and no branch on device values.

``base_dtype="int8"|"nf4"`` packs the frozen base once, at init, on the
engine's device (blocks of ``quant_block`` rows): every base matmul of a
step then runs the fused dequant kernel and the tenants' bypasses apply on
top, so N tenants share one packed base.

A VLM (qwen2-vl) serves text prompts as the dense family does: its steps
carry no M-RoPE positions, so q and k turn by plain RoPE at the token
positions, as in the reference's engine. The SSM and hybrid families have
no KV cache to page and are refused, with the reference's words; they
decode through their model API (``Model.prefill``, ``Model.decode_step``).

An MoE model (``cfg.num_experts > 0``) serves as the dense family does, on
any base and cache: the step's ``BatchedDelta`` leaves carry the slots' ids
into the MoE FFN, which scatters them through its expert dispatch. On a
packed base its expert stacks are dequantized per call (``ops.bmm_q``),
its attention projections and untied head run the fused dequant kernel.

With ``draft != "off"`` the decode megastep runs ``decode_chunk``
*speculative* rounds instead (:mod:`repro_torch.serve.draft`): a drafter
proposes ``spec_k`` tokens a slot (a model drafter by ``spec_k + 1``
one-token steps on its own dense scratch cache, :class:`DraftKVCache`; the
``ngram`` drafter from the slot's committed tokens), the served model
scores ``[token, d_1 .. d_K]`` as one verify chunk, and rejection sampling
keeps a prefix: an exact token match on greedy rows, so greedy outputs
equal ``draft="off"``'s. Rollback is a position that advances only by what
was emitted: the step boundary reserves ``decode_chunk × (spec_k + 1)``
positions a slot, so every row a rejected draft wrote is already the
slot's. Still one device-to-host transfer a megastep. A model drafter also
takes every mixed step's chunk into its scratch (its k/v only, no head).

Observability (DESIGN §13) is host-side by construction: every counter,
gauge, histogram and trace span derives from the step's one fetched bundle
or from host bookkeeping (queue, pool free list, the clock), so metrics
and tracing add no device operation and no transfer. ``metrics=False``
swaps in the no-op registry; ``tracer=None`` (the default) skips tracing.

The request lifecycle (DESIGN §16): ``submit(deadline=, timeout=)`` with
deadline-aware shedding, a bounded queue (``queue_limit``), per-tenant
token buckets (:meth:`set_rate_limit`), ``fairness="fifo"|"drr"``
admission, :meth:`cancel` wherever a request is, the boundary deadline
sweep, :meth:`drain`, and a seeded :class:`~repro_torch.serve.chaos.ChaosMonkey`
called at the top of every step. Every request leaves through
:meth:`_terminate`. One clock (``clock=``, else the tracer's, else
:func:`repro_torch.obs.now`) stamps requests, histograms, deadlines and
spans alike.

Tensor parallelism (DESIGN §14): ``tp_group`` (a
:class:`~repro_torch.distributed.collectives.TPGroup` of tp > 1) makes this
engine one rank of a sharded engine, one process a rank. The head counts
are checked before any placement, with the reference's words; each rank
then holds its slice of the base (and of a model drafter's base), of the
tenants' stacks and of the KV pools, and runs every step inside the
serving context (:mod:`repro_torch.distributed.context`), restored
afterwards, as the reference's ``_sharded_call``. Rank 0 is the *leader*:
it alone takes submits, cancels, rate limits, the chaos schedule and the
front end. At the top of each :meth:`step`, after the chaos injections, it
broadcasts one control record over the group's host-side gloo group: the
submits (with their rids and resolved deadlines) and cancels since the
last step, the in-flight deadlines, the pool blocks chaos holds and its
clock reading for the deadline sweep. The other ranks run :meth:`follow`,
which applies each record to their own scheduler and runs the same step
until :meth:`close` sends the shutdown record. The logits are all-gathered
before the sampler, so they are identical on every rank, and every rank's
generator has the same seed: all ranks sample the same tokens and their
schedules cannot part. Every rank makes one device-to-host fetch a step.
Every family the engine serves is served tensor-parallel, as the
reference's: the dense family and the VLM on the Megatron layout, the MoE
family with its experts split over the ranks (expert parallelism, one
all-reduce a MoE layer; replicated where tp does not divide the experts).
"""

from __future__ import annotations

import math

import numpy as np
import torch

import repro_torch.obs.clock as _clock
from repro_torch.core.delta import BatchedDelta
from repro_torch.device import resolve_device
from repro_torch.distributed import context as tp_ctx
from repro_torch.distributed.collectives import broadcast_record
from repro_torch.distributed.sharding import param_shapes, shard_params
from repro_torch.obs import MetricsRegistry, NullRegistry, Tracer
from repro_torch.peft import BASE_DTYPES, quantize_base
from repro_torch.serve.adapters import AdapterStore
from repro_torch.serve.draft import DRAFT_MODES, build_draft_params
from repro_torch.serve.kv_cache import KV_DTYPES, DraftKVCache, KVCache, PagedKVCache
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.scheduler import (
    POLICIES,
    QueueFullError,
    RateLimitedError,
    Request,
    Scheduler,
)
from repro_torch.tree import map_leaves

__all__ = ["QueueFullError", "RateLimitedError", "Request", "ServeEngine"]


def _finite_or_raise(name: str, value):
    """None passes through; anything else must coerce to a finite float."""
    if value is None:
        return None
    try:
        value = float(value)
    except (TypeError, ValueError):
        raise ValueError(f"{name} must be a finite number, got {value!r}") from None
    if not math.isfinite(value):
        raise ValueError(f"{name} must be a finite number, got {value!r}")
    return value


class ServeEngine:
    """The serving engine. ``paged=True`` is its default, as it is the
    reference launcher's and every caller of the port assumes; the
    reference *engine* (``repro.serve.ServeEngine``) defaults to
    ``paged=False``, so a comparison passes ``paged`` to both explicitly.
    ``page_size`` and ``num_blocks`` apply to the paged pool only.
    ``tp_group`` makes it one rank of a tensor-parallel engine (see the
    module note)."""

    def __init__(
        self,
        model,
        params,
        *,
        slots: int = 4,
        max_len: int = 256,
        eos_id: int = 2,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        seed: int = 0,
        adapter_store: AdapterStore | None = None,
        decode_chunk: int = 1,
        prefill_chunk: int = 256,
        page_size: int = 16,
        num_blocks: int | None = None,
        base_dtype: str = "fp32",
        quant_block: int = 64,
        paged: bool = True,
        kv_dtype: str = "fp32",
        draft: str = "off",
        spec_k: int = 4,
        metrics: MetricsRegistry | bool | None = None,
        tracer: Tracer | None = None,
        queue_limit: int | None = None,
        fairness: str = "fifo",
        quantum: int = 256,
        chaos=None,
        clock=None,
        device=None,
        tp_group=None,
    ):
        if model.cfg.family not in ("dense", "moe", "vlm"):
            # the engine drives the KV-cache LMs; the SSM and hybrid families
            # decode through their model API (prefill, decode_step)
            raise ValueError(f"ServeEngine supports KV LMs, got {model.cfg.family}")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if paged and (page_size < 1 or page_size & (page_size - 1)):
            raise ValueError(f"page_size must be a power of two, got {page_size}")
        if base_dtype not in BASE_DTYPES:
            raise ValueError(f"base_dtype {base_dtype!r} not in {BASE_DTYPES}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        if draft not in DRAFT_MODES:
            raise ValueError(f"draft {draft!r} not in {DRAFT_MODES}")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if draft == "merged" and (adapter_store is None or adapter_store.num_adapters == 0):
            raise ValueError("draft='merged' needs an adapter store with registered tenants")
        if fairness not in POLICIES:
            raise ValueError(f"fairness {fairness!r} not in {POLICIES}")
        # tensor-parallel serving (DESIGN §14), validated before any placement
        self.tp_group = tp_group if tp_group is not None and tp_group.tp > 1 else None
        self.tp = 1 if self.tp_group is None else self.tp_group.tp
        cfg = model.cfg
        if self.tp > 1:
            if cfg.num_kv_heads % self.tp:
                raise ValueError(
                    f"tp={self.tp} does not divide num_kv_heads={cfg.num_kv_heads} — the KV "
                    "pool partitions along the kv-head axis, so heads must split evenly")
            if cfg.num_heads % self.tp:
                raise ValueError(f"tp={self.tp} does not divide num_heads={cfg.num_heads}")
            if device is None:
                device = self.tp_group.device
        self.device = resolve_device(device)
        self.model = model
        self.params = map_leaves(lambda t: None if t is None else t.to(self.device), params)
        # quant_block must match the base the adapters were trained against
        self.params = quantize_base(self.params, base_dtype, block=quant_block)
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.store = adapter_store
        self.decode_chunk = decode_chunk
        self.prefill_chunk = min(prefill_chunk, max_len)
        # one registry an engine unless the caller shares one; False swaps
        # in the no-op registry. The transfer, preemption and spec tallies
        # live in it, re-exported as read-only properties.
        if metrics is None or metrics is True:
            self.metrics = MetricsRegistry()
        elif metrics is False:
            self.metrics = NullRegistry()
        else:
            self.metrics = metrics
        self.tracer = tracer
        self._queued_ts: dict[int, float] = {}  # rid -> the tracer's enqueue ts
        # one clock for every lifecycle timestamp: an explicit clock= wins,
        # else the tracer's (spans and histograms share a source), else
        # repro_torch.obs.clock
        if clock is not None:
            self.clock = clock
        elif tracer is not None:
            self.clock = tracer.clock
        else:
            self.clock = _clock.now
        self.chaos = chaos
        self.draining = False  # graceful shutdown: intake closed
        # seconds-a-step EMA for deadline-aware admission (None until
        # measured). The first step of each kind never feeds it: that step
        # loads the kernel library and creates cuBLAS's handles, seconds
        # that would shed every deadline-bearing request.
        self.step_seconds_ema: float | None = None
        self._step_timed: set[str] = set()
        self.scheduler = Scheduler(slots, policy=fairness, queue_limit=queue_limit,
                                   quantum=quantum, clock=self.clock)
        self.paged = paged
        self.kv_dtype = kv_dtype
        if paged:
            if num_blocks is None:
                num_blocks = slots * -(-max_len // page_size)
            self.kv = PagedKVCache(model, slots, max_len, page_size, num_blocks, self.device,
                                   kv_dtype=kv_dtype, tp=self.tp)
        else:
            self.kv = KVCache(model, slots, max_len, self.device, kv_dtype=kv_dtype, tp=self.tp)
        self.sampler = Sampler(model.cfg.vocab_size, top_k=top_k, top_p=top_p)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draft = draft
        self.spec_k = spec_k
        # a model drafter's params (derived once from the served ones) and
        # dense scratch; the ngram drafter needs neither
        self.draft_params = build_draft_params(self.params, draft, store=adapter_store,
                                               quant_block=quant_block)
        self._shapes = None  # the unsharded base's logical shapes: the tenants' hosts
        if self.tp > 1:
            # each rank's slices: the base and a model drafter's base alike
            rank = self.tp_group.rank
            self._shapes = param_shapes(self.params)
            self.params = shard_params(self.params, cfg.family, rank, self.tp)
            if self.draft_params is not None:
                self.draft_params = shard_params(self.draft_params, cfg.family, rank, self.tp)
        self.draft_kv = (None if self.draft_params is None
                         else DraftKVCache(model, slots, max_len, self.device, tp=self.tp))
        self._journal: list = []  # the leader's submits and cancels since its last record
        self.steps = 0
        self.step_times: dict[str, list[float]] = {"mixed": [], "decode": [], "spec": []}
        self.emitted = {kind: 0 for kind in self.step_times}  # tokens by step kind
        self._obs_init()

    # ------------------------------------------------ observability (§13)

    def _obs_init(self) -> None:
        """Bind every metric child once, with the reference's series names
        and labels: the hot path touches bound instruments only. Step-kind
        series carry ``kind`` (mixed | decode | spec), request series
        ``tenant`` (the adapter id as a string, ``0`` = base)."""
        reg = self.metrics
        self._c_transfers = reg.counter(
            "serve_transfers_total",
            "Device-to-host fetches (exactly one per compiled step).")
        steps = reg.counter("serve_steps_total", "Compiled serving steps.", labels=("kind",))
        toks = reg.counter("serve_tokens_total", "Tokens emitted.", labels=("kind",))
        secs = reg.histogram("serve_step_seconds", "Compiled-step wall time.", labels=("kind",))
        kinds = ("mixed", "decode", "spec")
        self._c_step = {k: steps.labels(k) for k in kinds}
        self._c_tokens = {k: toks.labels(k) for k in kinds}
        self._h_step = {k: secs.labels(k) for k in kinds}
        self._c_submitted = reg.counter(
            "serve_requests_submitted_total", "Requests accepted by submit().",
            labels=("tenant",))
        self._c_admitted = reg.counter(
            "serve_requests_admitted_total",
            "Queue-to-slot admissions (re-admissions after preemption included).",
            labels=("tenant",))
        self._c_finished = reg.counter(
            "serve_requests_finished_total", "Completed requests by termination reason.",
            labels=("tenant", "reason"))
        shed = reg.counter(
            "serve_requests_shed_total",
            "Requests refused at intake or admission (never a slot): bounded-queue "
            "overflow, tenant rate limit, or a deadline that cannot be met.",
            labels=("reason",))
        self._c_shed = {k: shed.labels(k) for k in ("queue_full", "rate_limit", "deadline")}
        cancelled = reg.counter(
            "serve_requests_cancelled_total",
            "cancel() calls that found a live request (mid-queue, mid-prefill or "
            "mid-decode).", labels=("phase",))
        self._c_cancelled = {k: cancelled.labels(k) for k in ("queued", "prefill", "decode")}
        expired = reg.counter(
            "serve_deadline_expired_total",
            "Requests evicted by the boundary deadline sweep.", labels=("phase",))
        self._c_expired = {k: expired.labels(k) for k in ("queued", "prefill", "decode")}
        pre = reg.counter(
            "serve_preemptions_total", "Block-pool OOM evictions back to the queue head.",
            labels=("phase",))
        self._c_preempt = {"decode": pre.labels("decode"), "prefill": pre.labels("prefill")}
        self._c_tenant_tokens = reg.counter(
            "serve_tenant_tokens_total", "Tokens emitted per tenant (adapter id 0 = base).",
            labels=("tenant",))
        self._h_ttft = reg.histogram("serve_ttft_seconds", "Submit-to-first-token latency.")
        self._h_itl = reg.histogram(
            "serve_itl_seconds",
            "Inter-token latency (host arrival; tokens sharing a megastep split its "
            "wall evenly).")
        self._g_queue = reg.gauge("serve_queue_depth", "Requests waiting for a slot.")
        self._g_active = reg.gauge("serve_slots_active", "Slots holding an admitted request.")
        self._g_tenants = reg.gauge("serve_tenants_registered", "Adapters in the tenant store.")
        # the port compiles no step variants: the series stays (the serve
        # launcher's digest reads it) at 0
        reg.gauge("serve_jit_compiles",
                  "Compiled variants across all step functions (jit cache entries); "
                  "flat after warmup.")
        self._g_stack_builds = reg.gauge(
            "serve_adapter_stack_builds",
            "Full tenant-tree re-stacks (should track register/remove count, not step "
            "count).")
        reg.gauge("serve_tp_size",
                  "Tensor-parallel shards serving this engine (1 = unsharded).").set(self.tp)
        reg.gauge("serve_pool_bytes",
                  "Effective packed KV cache/pool bytes (data + scales) across all shards "
                  "(logical total).", labels=("kv_dtype",)
                  ).labels(self.kv_dtype).set(self.kv.pool_bytes())
        reg.gauge("serve_pool_bytes_per_shard",
                  "Effective packed KV cache/pool bytes ONE shard holds (total / TP "
                  "sharded).", labels=("kv_dtype",)
                  ).labels(self.kv_dtype).set(self.kv.pool_bytes_per_shard())
        if self.paged:
            self._g_pool_used = reg.gauge("serve_pool_blocks_used", "KV pool blocks allocated.")
            self._g_pool_free = reg.gauge("serve_pool_blocks_free",
                                          "KV pool blocks on the free list.")
            self._g_pool_shared = reg.gauge("serve_pool_shared_blocks",
                                            "Blocks referenced by >1 slot (live prefix reuse).")
            self._c_prefix_hit = reg.counter(
                "serve_prefix_pages_hit_total",
                "Admission prompt pages dedup'd against resident blocks.")
            self._c_prefix_fresh = reg.counter(
                "serve_prefix_pages_fresh_total", "Admission prompt pages freshly allocated.")
            self._scraped_prefix = (0, 0)
        if self.draft != "off":
            self._c_spec_drafted = reg.counter("serve_spec_drafted_total",
                                               "Drafter proposals (all slots).")
            self._c_spec_accepted = reg.counter("serve_spec_accepted_total",
                                                "Proposals the verifier accepted.")
            self._c_spec_emitted = reg.counter("serve_spec_emitted_total",
                                               "Tokens emitted through the speculative path.")
            self._h_spec_accept = reg.histogram(
                "serve_spec_accept_len",
                "Accepted-prefix length per live slot-round (0..spec_k).",
                buckets=tuple(float(i) for i in range(self.spec_k + 1)))

    def _update_gauges(self) -> None:
        """Refresh the point-in-time gauges after a step from host state
        (queue, slots, the pool's free list and host refcounts)."""
        self._g_queue.set(self.scheduler.queue_depth)
        self._g_active.set(sum(r is not None for r in self.scheduler.active))
        if self.store is not None:
            self._g_tenants.set(self.store.num_adapters)
            self._g_stack_builds.set(self.store.stack_builds)
        if self.paged:
            self._g_pool_used.set(self.kv.used_blocks)
            self._g_pool_free.set(self.kv.free_blocks)
            self._g_pool_shared.set(self.kv.shared_blocks)
            hits, fresh = self.kv.prefix_page_hits, self.kv.prefix_page_fresh
            h0, f0 = self._scraped_prefix
            self._c_prefix_hit.inc(hits - h0)
            self._c_prefix_fresh.inc(fresh - f0)
            self._scraped_prefix = (hits, fresh)

    def _emit_token(self, req: Request, tok: int, now: float) -> None:
        """Append one emitted token and observe its latency: the first token
        of a request TTFT, a later one ITL (tokens of one step arrive at the
        host together, at ``now``). A clock that read 0.0 at the previous
        token observes no ITL, as in the reference."""
        req.out.append(tok)
        if len(req.out) == 1:
            self._h_ttft.observe(now - req.t_submit)
            if self.tracer is not None:
                self.tracer.instant(req.rid, "first_token")
        elif req.t_last:
            self._h_itl.observe(now - req.t_last)
        req.t_last = now
        self._c_tenant_tokens.labels(str(req.adapter_id)).inc()

    # ---------------------------------------- registry-backed telemetry

    @property
    def transfers(self) -> int:
        """Device-to-host fetches: one a step (0 under ``metrics=False``)."""
        return int(self._c_transfers.value)

    @property
    def preemptions(self) -> int:
        """Block-pool evictions back to the queue (paged only), all phases."""
        return int(self._c_preempt["decode"].value + self._c_preempt["prefill"].value)

    @property
    def preemptions_mid_prefill(self) -> int:
        """Of them, victims still owing prompt chunks."""
        return int(self._c_preempt["prefill"].value)

    @property
    def spec_drafted(self) -> int:
        """Drafter proposals: spec_k a live slot-round."""
        return int(self._c_spec_drafted.value) if self.draft != "off" else 0

    @property
    def spec_accepted(self) -> int:
        return int(self._c_spec_accepted.value) if self.draft != "off" else 0

    @property
    def spec_emitted(self) -> int:
        """Tokens the speculative megasteps emitted."""
        return int(self._c_spec_emitted.value) if self.draft != "off" else 0

    # ------------------------------------------------------------- intake

    def submit(self, prompt: list[int], max_new: int = 32, *, adapter_id: int = 0,
               temperature: float | None = None, deadline: float | None = None,
               timeout: float | None = None) -> int:
        """Enqueue one request. ``timeout`` (seconds from now) is sugar for
        an absolute ``deadline`` on the engine clock; a request whose
        deadline passes, queued or admitted, ends at the next step boundary
        with reason "deadline". Raises ValueError on a malformed request,
        :class:`QueueFullError` / :class:`RateLimitedError` on a shed (both
        carry ``retry_after``), RuntimeError once :meth:`drain` closed
        intake."""
        if self.tp_group is not None and not self.tp_group.leader:
            raise RuntimeError("submit() on a follower rank: requests go to the leader")
        if not prompt:
            raise ValueError("empty prompt")
        if max_new <= 0:
            raise ValueError(f"max_new must be positive, got {max_new}")
        if self.draining:
            raise RuntimeError("engine is draining: intake closed")
        if len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} >= max_len {self.max_len}")
        n_reg = self.store.num_adapters if self.store is not None else 0
        if not 0 <= adapter_id <= n_reg:
            raise ValueError(f"adapter_id {adapter_id} not registered (have {n_reg} + base)")
        # coerced here: a bad value is a ValueError at intake, never a crash
        # inside step() (which would end a whole server)
        temperature = _finite_or_raise("temperature", temperature)
        deadline = _finite_or_raise("deadline", deadline)
        timeout = _finite_or_raise("timeout", timeout)
        if timeout is not None:
            if timeout <= 0:
                raise ValueError(f"timeout must be positive, got {timeout}")
            deadline = self.clock() + timeout
        if deadline is not None and self.step_seconds_ema is not None:
            # deadline-aware admission: a request needs about one step for a
            # token even if admitted at once; shed it now if the deadline
            # cannot cover that
            if deadline - self.clock() < self.step_seconds_ema:
                self._c_shed["deadline"].inc()
                raise QueueFullError(
                    self.scheduler.queue_depth, self.scheduler.queue_limit, retry_after=0.0,
                    reason="deadline unreachable: "
                    f"{max(deadline - self.clock(), 0.0):.3f}s left, "
                    f"steps take ~{self.step_seconds_ema:.3f}s")
        temp = self.temperature if temperature is None else temperature
        try:
            rid = self.scheduler.submit(
                prompt, max_new, adapter_id=adapter_id, temperature=temp,
                store_rev=self.store.removals if self.store is not None else 0,
                deadline=deadline)
        except QueueFullError:
            self._c_shed["queue_full"].inc()
            raise
        except RateLimitedError:
            self._c_shed["rate_limit"].inc()
            raise
        if self.tp_group is not None:
            self._journal.append(("submit", rid, list(prompt), max_new, adapter_id, temp,
                                  self.scheduler.get(rid).store_rev, deadline))
        self._accepted(rid, len(prompt), max_new, adapter_id)
        return rid

    def _accepted(self, rid: int, n_prompt: int, max_new: int, adapter_id: int) -> None:
        """Count and trace an accepted submit."""
        self._c_submitted.labels(str(adapter_id)).inc()
        self._g_queue.set(self.scheduler.queue_depth)
        if self.tracer is not None:
            ts = self.tracer.now()
            self.tracer.instant(rid, "submit", ts=ts, prompt_tokens=n_prompt,
                                max_new=max_new, tenant=adapter_id)
            self._queued_ts[rid] = ts

    def set_rate_limit(self, adapter_id: int, rate: float, burst: float | None = None) -> None:
        """Per-tenant token bucket: ``rate`` submits a second sustained,
        ``burst`` headroom; a violator gets :class:`RateLimitedError`."""
        self.scheduler.set_rate_limit(adapter_id, rate, burst=burst)

    # -------------------------------------------- cancellation and deadlines

    def cancel(self, rid: int) -> bool:
        """Cancel one request wherever it is (queued, mid-prefill or
        mid-decode), reclaiming its slot and pages as a preemption does,
        without the re-queue. False when the rid is unknown or already
        terminal. Between steps only: the front end routes cancels through
        its engine thread."""
        req = self.scheduler.get(rid)
        if req is None or req.done:
            return False
        if self.tp_group is not None and self.tp_group.leader:
            self._journal.append(("cancel", rid))
        req.cancelled = True
        slot = self.scheduler.slot_of(rid)
        if slot is None:
            phase = "queued"
            self.scheduler.remove_queued(rid)
        else:
            phase = "prefill" if req.mid_prefill else "decode"
        self._c_cancelled[phase].inc()
        self._terminate(slot, req, "cancelled")
        self._g_queue.set(self.scheduler.queue_depth)
        return True

    def _expire_deadlines(self, now: float) -> None:
        """Boundary sweep before admission at clock reading ``now``: every
        in-flight request whose deadline has passed, queued or admitted,
        ends with reason "deadline" (so an expired request never takes a
        slot)."""
        for req in self.scheduler.expired_queued(now):
            self._c_expired["queued"].inc()
            self._terminate(None, req, "deadline")
        for slot, req in enumerate(self.scheduler.active):
            if req is not None and req.deadline is not None and req.deadline <= now:
                self._c_expired["prefill" if req.mid_prefill else "decode"].inc()
                self._terminate(slot, req, "deadline")
        self._g_queue.set(self.scheduler.queue_depth)

    def drain(self) -> list[Request]:
        """Graceful shutdown: close intake, run every in-flight request to
        its end, return them (the pool is then fully free)."""
        self.draining = True
        return self.run_to_completion()

    def _check_adapter_ids(self) -> None:
        """A ``store.remove()`` shifts ids: a request validated against an
        older store revision must not decode with another tenant's delta."""
        if self.store is None:
            return
        for req in self.scheduler.in_flight():
            if req.adapter_id > 0 and req.store_rev != self.store.removals:
                raise RuntimeError(
                    f"request {req.rid} holds adapter_id {req.adapter_id} validated "
                    "against a store revision that has since seen remove(); drain "
                    "in-flight requests before removing tenants")

    def _try_place(self, slot: int, req: Request) -> bool:
        """Block-aware admission: reserve the prompt's pages (shared prefix
        pages dedup against written blocks) plus the first decode
        megastep's horizon, or refuse. A prefix hit fast-forwards the chunk
        walk, except under a model drafter: its dense scratch shares no
        page and must take every token of the prompt itself."""
        toks = req.prompt + req.out
        shared_lead = self.kv.admit(slot, toks, req.adapter_id)
        if shared_lead is None:
            return False
        if not self.kv.reserve(slot, min(len(toks) + self._decode_horizon(), self.max_len)):
            self.kv.evict(slot)
            return False
        if self.draft_kv is None:
            req.prefilled = min(shared_lead, req.prefill_target - 1)
        return True

    def _admit(self) -> None:
        """Admission round: queued requests enter free slots (paged: when
        the pool covers them), counted and traced."""
        placed = self.scheduler.admissible(self._try_place if self.paged else None)
        for slot, req in placed:
            self._c_admitted.labels(str(req.adapter_id)).inc()
            if self.tracer is not None:
                now = self.tracer.now()
                t_q = self._queued_ts.pop(req.rid, now)
                self.tracer.span(req.rid, "queued", t_q, now)
                self.tracer.instant(req.rid, "admitted", ts=now, slot=slot,
                                    resume=bool(req.out), prefill_target=req.prefill_target,
                                    prefilled=req.prefilled)

    def _decode_horizon(self) -> int:
        """How far one decode megastep can move a slot's position: a token
        a step plain, spec_k accepted drafts and one more a round
        speculative. Step boundaries reserve pages that far ahead, so the
        steps never allocate and a rejected draft's rows are the slot's."""
        if self.draft == "off":
            return self.decode_chunk
        return self.decode_chunk * (self.spec_k + 1)

    # --------------------------------------------------------------- step

    @torch.no_grad()
    def step(self) -> bool:
        """One mixed chunk step or one decode megastep over all active
        slots; False when nothing is admitted or queued. Chaos injections,
        the deadline sweep and admission run first, at the boundary. On a
        tensor-parallel leader the control record goes out after the chaos
        injections (see the module note)."""
        if self.chaos is not None:
            # before the sweep (a stormed deadline expires this step) and
            # before admission (stolen blocks refuse placements this step)
            self.chaos.on_step(self)
        now = self.clock()
        if self.tp_group is None:
            return self._boundary_and_step(now)
        if not self.tp_group.leader:
            raise RuntimeError("step() on a follower rank: followers run follow()")
        broadcast_record(self._record(now), self.tp_group)
        return self._sharded(self._boundary_and_step, now)

    # ------------------------------------------ tensor-parallel lockstep

    def _record(self, now: float) -> dict:
        """The leader's control record of this step: the journal since the
        last record, every in-flight deadline, the blocks chaos holds, and
        ``now``, the clock reading of the deadline sweep."""
        ops, self._journal = self._journal, []
        return {"ops": ops, "now": now,
                "deadlines": {r.rid: r.deadline for r in self.scheduler.in_flight()
                              if r.deadline is not None},
                "stolen": self.kv.stolen_blocks if self.paged else 0}

    def _sharded(self, fn, *args):
        """``fn(*args)`` inside the serving context, restored afterwards
        (the reference's ``_sharded_call``)."""
        snap = tp_ctx.snapshot()
        tp_ctx.set_serve_group(self.tp_group, (self.model.cfg.num_heads,
                                               self.model.cfg.num_kv_heads))
        try:
            return fn(*args)
        finally:
            tp_ctx.restore(snap)

    def _apply(self, record: dict) -> None:
        """Replay the leader's record on a follower: submits with the
        leader's rids, cancels, deadlines and chaos's held blocks."""
        for op in record["ops"]:
            if op[0] == "submit":
                rid, prompt, max_new, aid, temp, rev, deadline = op[1:]
                got = self.scheduler.submit(prompt, max_new, adapter_id=aid, temperature=temp,
                                            store_rev=rev, deadline=deadline)
                if got != rid:
                    raise RuntimeError(f"follower rank {self.tp_group.rank} gave rid {got} "
                                       f"to the leader's request {rid}")
                self._accepted(rid, len(prompt), max_new, aid)
            else:
                self.cancel(op[1])
        for rid, deadline in record["deadlines"].items():
            req = self.scheduler.get(rid)
            if req is not None:
                req.deadline = deadline
        held = record["stolen"] - (self.kv.stolen_blocks if self.paged else 0)
        if held > 0:
            self.kv.steal_blocks(held)
        elif held < 0:
            self.kv.restore_blocks(-held)

    def follow(self) -> None:
        """A follower rank's loop: apply each of the leader's records and run
        the same step, until the leader's :meth:`close`."""
        if self.tp_group is None or self.tp_group.leader:
            raise RuntimeError("follow() is for the follower ranks of a tensor-parallel engine")
        with torch.no_grad():
            while True:
                record = broadcast_record(None, self.tp_group)
                if record is None:
                    return
                self._apply(record)
                self._sharded(self._boundary_and_step, record["now"])

    def close(self) -> None:
        """On a tensor-parallel leader: send the shutdown record that ends
        the followers' :meth:`follow`. A no-op otherwise."""
        if self.tp_group is not None and self.tp_group.leader:
            broadcast_record(None, self.tp_group)

    def _boundary_and_step(self, now: float) -> bool:
        """The deadline sweep at ``now``, admission, then the step itself."""
        self._expire_deadlines(now)
        self._check_adapter_ids()
        self._admit()
        if not self.scheduler.has_active():
            if self.chaos is not None:
                # this step's injections may have ended the last request:
                # hand stolen blocks back before reporting idle
                self.chaos.release(self)
            elif self.tp_group is not None and self.paged and self.kv.stolen_blocks:
                self.kv.restore_blocks()  # a follower: the leader's chaos released here
            return False
        t0 = self.clock()
        if self.scheduler.has_prefilling():
            kind = "mixed"
            self._chunk_step()
        elif self.draft != "off":
            kind = "spec"
            self._spec_decode_step()
        else:
            kind = "decode"
            self._decode_step()
        dt = self.clock() - t0
        self.step_times[kind].append(dt)
        self.steps += 1
        self._h_step[kind].observe(dt)
        self._c_step[kind].inc()
        # the EMA behind deadline-aware admission skips each kind's first
        # step and later spikes of more than 10x the estimate
        if kind not in self._step_timed:
            self._step_timed.add(kind)
        elif self.step_seconds_ema is None:
            self.step_seconds_ema = dt
        elif dt < 10.0 * self.step_seconds_ema:
            self.step_seconds_ema = 0.9 * self.step_seconds_ema + 0.1 * dt
        self._update_gauges()
        return True

    def run_to_completion(self) -> list[Request]:
        """Serve everything queued or admitted; returns those requests in
        submit order."""
        reqs = self.scheduler.in_flight()
        while self.step():
            pass
        return reqs

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _fetch(self, bundle: torch.Tensor) -> np.ndarray:
        """The step's one device-to-host transfer."""
        self._c_transfers.inc()
        return bundle.cpu().numpy()

    def _adapters(self, aid: np.ndarray):
        """The step's ``{"blocks": {name: BatchedDelta}, "head": ...}``
        over the cached tenant stacks (this rank's slices under tensor
        parallelism), with one adapter id per slot."""
        stacked = None
        if self.store is not None:
            rank = 0 if self.tp_group is None else self.tp_group.rank
            stacked = self.store.stacked(self.device, rank, self.tp, self._shapes,
                                         self.model.cfg.family)
        if stacked is None:
            return None
        sidx, sval = stacked
        aid_t = self._tensor(aid)
        blocks = {}
        for name, leaf in sidx["blocks"].items():
            if isinstance(leaf, dict) and leaf.get("w") is not None:
                blocks[name] = BatchedDelta(leaf["w"], sval["blocks"][name]["w"], aid_t)
        head = sidx.get("head")
        if isinstance(head, dict) and head.get("w") is not None:
            head = BatchedDelta(head["w"], sval["head"]["w"], aid_t)
        else:
            head = None
        return {"blocks": blocks, "head": head}

    def _chunk_step(self) -> None:
        """Mixed prefill+decode step: carve the chunk plan, pre-reserve the
        decode slots' next position (paged), run the chunk forward, sample."""
        tr0 = self.tracer.now() if self.tracer is not None else 0.0
        if self.paged:
            self._reserve(1)
        plan = self.scheduler.chunk_plan(self.prefill_chunk, self.kv.pos_host)
        q_offset, q_len = self._tensor(plan["q_offset"]), self._tensor(plan["q_len"])
        batch = {
            "tokens": self._tensor(plan["tokens"]), "q_offset": q_offset, "q_len": q_len,
            "last_idx": self._tensor(plan["last_idx"]),
        }
        if self.paged:
            batch["block_table"] = self.kv.table_device()
            batch["write_table"] = self.kv.write_table_device()
        logits = self.model.prefill_chunk(self.params, self._adapters(plan["aid"]),
                                          self.kv.data, batch)
        if self.draft_kv is not None:  # the drafter takes the same chunk into its scratch
            self.model.ingest_chunk(self.draft_params, None, self.draft_kv.data,
                                    {"tokens": batch["tokens"], "q_offset": q_offset,
                                     "q_len": q_len})
        toks = self._fetch(self.sampler(logits, self._tensor(plan["temps"]), self.generator))
        # positions advance to q_offset + q_len; the host mirrors them
        self.kv.sync(q_offset + q_len, plan["q_offset"] + plan["q_len"])
        now = self.clock()
        tr1 = self.tracer.now() if self.tracer is not None else 0.0
        n_emit = 0
        for s, req in enumerate(self.scheduler.active):
            if req is None:
                continue
            take = int(plan["q_len"][s])
            if take and req.mid_prefill:
                if self.tracer is not None:
                    self.tracer.span(req.rid, "prefill_chunk", tr0, tr1, tokens=take,
                                     offset=int(plan["q_offset"][s]))
                req.prefilled += take
                if self.paged:
                    self.kv.mark_prefilled(s, req.prefilled)
            elif take and self.tracer is not None:
                # a decode slot riding the mixed step as a one-token chunk
                self.tracer.span(req.rid, "decode", tr0, tr1, tokens=1, mixed=True)
            if plan["emit"][s]:
                n_emit += 1
                self._emit_token(req, int(toks[s]), now)
                self._maybe_finish(s, req)
        self.emitted["mixed"] += n_emit
        self._c_tokens["mixed"].inc(n_emit)

    def _reserve(self, horizon: int) -> None:
        """Give every decode slot pages up to ``pos + horizon`` (capped at
        ``max_len``) so the step never allocates; on shortfall preempt the
        youngest admitted request back to the queue head and retry."""
        while True:
            short = False
            for s, req in enumerate(self.scheduler.active):
                if req is None or req.mid_prefill:
                    continue
                target = min(int(self.kv.pos_host[s]) + horizon, self.max_len)
                if not self.kv.reserve(s, target):
                    short = True
                    break
            if not short:
                return
            self._preempt_youngest()

    def _preempt_youngest(self) -> None:
        victim = self.scheduler.youngest_active()
        if sum(r is not None for r in self.scheduler.active) <= 1:
            raise RuntimeError("paged KV pool cannot hold a single request's chunk")
        req = self.scheduler.active[victim]
        phase = "prefill" if req.mid_prefill else "decode"
        self._c_preempt[phase].inc()
        if self.tracer is not None:
            now = self.tracer.now()
            self.tracer.instant(req.rid, "preempt", phase=phase, slot=victim,
                                tokens_done=len(req.out))
            self._queued_ts[req.rid] = now  # back at the queue head: queued again
        self.scheduler.preempt(victim)
        self.kv.evict(victim)

    def _decode_step(self) -> None:
        """Decode megastep: up to ``decode_chunk`` tokens per slot with the
        token, position, budget and active mask carried on the device."""
        tr0 = self.tracer.now() if self.tracer is not None else 0.0
        if self.paged:
            self._reserve(self._decode_horizon())
        st = self.scheduler.slot_arrays()
        tok, active = self._tensor(st["tokens"]), self._tensor(st["active"])
        remaining, temps = self._tensor(st["remaining"]), self._tensor(st["temps"])
        pos = self.kv.pos
        adapters = self._adapters(st["aid"])
        table = {"block_table": self.kv.table_device()} if self.paged else {}
        toks, emits = [], []
        for _ in range(self.decode_chunk):
            logits = self.model.decode_step(
                self.params, adapters, self.kv.data,
                {"token": tok, "pos": pos, "active": active, **table})
            nxt = self.sampler(logits, temps, self.generator)
            emits.append(active)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            remaining = torch.where(active, remaining - 1, remaining)
            # the host lifecycle's stop rules (EOS | max_new | cache full),
            # taken after the advance
            active = active & (tok != self.eos_id) & (remaining > 0) & (pos < self.max_len - 1)
            toks.append(tok)
        n, c = self.slots, self.decode_chunk
        host = self._fetch(torch.cat([
            torch.stack(toks).reshape(-1), torch.stack(emits).reshape(-1).to(torch.int32),
            pos, active.to(torch.int32)]))
        toks_np = host[: c * n].reshape(c, n)
        emits_np = host[c * n: 2 * c * n].reshape(c, n).astype(bool)
        pos_np = host[2 * c * n: 2 * c * n + n]
        active_np = host[2 * c * n + n:].astype(bool)
        now = self.clock()
        tr1 = self.tracer.now() if self.tracer is not None else 0.0
        self.kv.sync(pos, pos_np)
        n_emit = 0
        for t in range(c):
            for s, req in enumerate(self.scheduler.active):
                if req is not None and emits_np[t, s]:
                    self._emit_token(req, int(toks_np[t, s]), now)
                    n_emit += 1
        self.emitted["decode"] += n_emit
        self._c_tokens["decode"].inc(n_emit)
        if self.tracer is not None:
            for s, req in enumerate(self.scheduler.active):
                if req is not None:
                    self.tracer.span(req.rid, "decode", tr0, tr1,
                                     tokens=int(emits_np[:, s].sum()))
        for s, req in enumerate(self.scheduler.active):
            if req is not None and not active_np[s]:
                self._finish(s, req)

    # --------------------------------------------------- speculative decode

    def _spec_decode_step(self) -> None:
        """Speculative decode megastep: ``decode_chunk`` draft / verify /
        accept rounds over all active slots, then the (round, slot, K + 1)
        emissions replayed into the requests from one fetched bundle."""
        tr0 = self.tracer.now() if self.tracer is not None else 0.0
        if self.paged:
            self._reserve(self._decode_horizon())
        st = self.scheduler.slot_arrays()
        hist = None
        if self.draft == "ngram":
            # hist[s, :len(seq)] is the committed sequence, so hist[s, pos[s]]
            # is the slot's current token; the last column is a trash column
            # for the rounds' appends of tokens not emitted
            host = np.zeros((self.slots, self.max_len + 1), np.int32)
            for s, req in enumerate(self.scheduler.active):
                if req is not None:
                    seq = req.prompt + req.out
                    host[s, : len(seq)] = seq
            hist = self._tensor(host)
        bundle = self._spec_rounds(
            self._adapters(st["aid"]), self.kv.table_device() if self.paged else None,
            self._tensor(st["tokens"]), self.kv.pos, self._tensor(st["active"]),
            self._tensor(st["remaining"]), self._tensor(st["temps"]), hist)
        host = self._fetch(bundle)
        r, n, c = self.decode_chunk, self.slots, self.spec_k + 1
        sizes = (n, n, r * n * c, r * n * c, r * n, r * n)
        pos_np, active_np, toks, emits, accs, lives = np.split(host, np.cumsum(sizes)[:-1])
        toks, emits = toks.reshape(r, n, c), emits.reshape(r, n, c).astype(bool)
        accs, lives = accs.reshape(r, n), lives.reshape(r, n).astype(bool)
        now = self.clock()
        tr1 = self.tracer.now() if self.tracer is not None else 0.0
        self.kv.sync(bundle[:n], pos_np)
        n_emit = 0
        slot_rounds, slot_tokens, slot_accepted = [0] * n, [0] * n, [0] * n
        for t in range(r):
            for s, req in enumerate(self.scheduler.active):
                if req is None:
                    continue
                if lives[t, s]:
                    acc = int(accs[t, s])
                    req.spec_drafted += self.spec_k
                    req.spec_accepted += acc
                    self._c_spec_drafted.inc(self.spec_k)
                    self._c_spec_accepted.inc(acc)
                    self._h_spec_accept.observe(acc)
                    slot_rounds[s] += 1
                    slot_accepted[s] += acc
                for j in range(c):
                    if emits[t, s, j]:
                        self._emit_token(req, int(toks[t, s, j]), now)
                        self._c_spec_emitted.inc()
                        n_emit += 1
                        slot_tokens[s] += 1
        self.emitted["spec"] += n_emit
        self._c_tokens["spec"].inc(n_emit)
        if self.tracer is not None:
            for s, req in enumerate(self.scheduler.active):
                if req is not None:
                    self.tracer.span(req.rid, "spec_round", tr0, tr1, rounds=slot_rounds[s],
                                     accepted=slot_accepted[s], tokens=slot_tokens[s])
        for s, req in enumerate(self.scheduler.active):
            if req is not None and not active_np[s]:
                self._finish(s, req)

    def _spec_rounds(self, adapters, table, tok, pos, active, remaining, temps, hist):
        """The device half of a speculative megastep: ``decode_chunk``
        rounds with every carry on the device (no ``.item()``, no
        boolean-mask indexing, no branch on device values). ``hist`` is the
        ngram drafter's (slots, max_len + 1) token history, None for a
        model drafter. Returns the int32 bundle: final positions and
        survivor mask, then per round the (slots, K + 1) candidates and
        emit mask, the accepted counts and the round-entry live mask."""
        k = self.spec_k
        toks, emits, accs, lives = [], [], [], []
        cols = torch.arange(k + 1, device=self.device)[None, :]
        for _ in range(self.decode_chunk):
            lives.append(active)
            if hist is None:
                d_t, q_t = self._model_drafts(tok, pos, active, temps)
            else:
                d_t, q_t = self._ngram_drafts(hist, tok, pos), None
            pos0 = pos
            tok, pos, active, remaining, cand, emit, a = self._verify_round(
                adapters, table, tok, pos, active, remaining, temps, d_t, q_t)
            if hist is not None:
                # committed tokens append at pos0 + 1.., the rest to the trash column
                wpos = torch.where(emit, pos0[:, None] + 1 + cols, self.max_len)
                hist.scatter_(1, wpos.long(), cand)
            toks.append(cand)
            emits.append(emit)
            accs.append(a)
        return torch.cat([pos, active.to(torch.int32), torch.stack(toks).reshape(-1),
                          torch.stack(emits).reshape(-1).to(torch.int32),
                          torch.stack(accs).reshape(-1),
                          torch.stack(lives).reshape(-1).to(torch.int32)])

    def _model_drafts(self, tok, pos, active, temps):
        """spec_k + 1 one-token drafter steps on the scratch cache from the
        verified frontier: (S, K) proposals and their (S, K, vocab)
        distributions. The last step only writes d_K's k/v, so a round
        whose drafts are all accepted leaves no hole in the scratch."""
        drafts, dists = [], []
        for i in range(self.spec_k + 1):
            logits = self.model.decode_step(self.draft_params, None, self.draft_kv.data,
                                            {"token": tok, "pos": pos, "active": active})
            if i == self.spec_k:
                break
            dists.append(self.sampler.probs(logits, temps))
            tok = self.sampler(logits, temps, self.generator)
            drafts.append(tok)
            pos = pos + 1
        return torch.stack(drafts, 1), torch.stack(dists, 1)

    def _ngram_drafts(self, hist, tok, pos):
        """(S, K) proposals from each slot's history: the tokens after the
        most recent earlier occurrence j of its current token, wrapped
        with period pos - j past the frontier (a cycle of period p then
        fills the whole window); token 0 where the token never occurred."""
        n = self.max_len
        at = torch.arange(n, device=self.device)[None, :]
        seen = (hist[:, :n] == tok[:, None]) & (at < pos[:, None])
        j = torch.where(seen, at, -1).amax(1)
        period = (pos - j).clamp(min=1)
        cols = j[:, None] + 1 + torch.remainder(
            torch.arange(self.spec_k, device=self.device)[None, :], period[:, None])
        d_t = torch.gather(hist, 1, cols.clamp(0, n - 1).long())
        return torch.where((j >= 0)[:, None], d_t, 0)

    def _verify_round(self, adapters, table, tok, pos, active, remaining, temps, d_t, q_t):
        """Score ``[tok, d_1 .. d_K]`` as one verify chunk and commit a
        verified prefix. ``q_t`` (S, K, vocab) holds the drafter's
        distributions, None for a deterministic drafter (q(d) = 1: accept
        when u < p(d), the residual p with the d column zeroed).

        The chunk's q_len stops at ``max_len - pos``; paged writes go
        through the read table (verify rows are decode positions the slot
        owns). Accept while ``u · q(d) < p(d)``; one draw from row a (the
        residual max(0, p - q) at the first rejection, the bonus row at a
        full accept). The stop rules (EOS | max_new | cache full) replay
        per emitted token, the trigger emitted and everything after it
        dropped. Rollback is a ``pos`` that advances by the emitted count
        only. Returns (tok, pos, active, remaining, candidates (S, K + 1),
        emit mask, accepted counts)."""
        k, n_s = self.spec_k, tok.shape[0]
        c = k + 1
        ctokens = torch.cat([tok[:, None], d_t.to(tok.dtype)], 1)
        q_len = torch.where(active, (self.max_len - pos).clamp(max=c), 0).to(torch.int32)
        vbatch = {"tokens": ctokens, "q_offset": pos, "q_len": q_len}
        if table is not None:
            vbatch["block_table"] = vbatch["write_table"] = table
        logits = self.model.verify_chunk(self.params, adapters, self.kv.data, vbatch)
        p_t = self.sampler.probs(logits.reshape(n_s * c, -1),
                                 temps[:, None].expand(n_s, c).reshape(-1)).reshape(n_s, c, -1)
        vocab = p_t.shape[-1]
        d_l = d_t.long()
        u = torch.rand((n_s, k), generator=self.generator, device=self.device)
        p_d = torch.gather(p_t[:, :k], 2, d_l[..., None])[..., 0]
        if q_t is None:
            acc = u < p_d
        else:
            acc = u * torch.gather(q_t, 2, d_l[..., None])[..., 0].clamp(min=1e-30) < p_d
        a = ((~acc).to(torch.int32).cumsum(1) == 0).sum(1)  # drafts accepted before a rejection
        p_sel = torch.gather(p_t, 1, a[:, None, None].expand(n_s, 1, vocab))[:, 0]
        rej = a.clamp(max=k - 1)[:, None]  # the first rejected column (a < K)
        if q_t is None:
            # zero the rejected proposal's column; at a = K a trash column
            d_rej = torch.where(a < k, torch.gather(d_l, 1, rej)[:, 0], vocab)
            res = torch.cat([p_sel, p_sel.new_zeros(n_s, 1)], 1)
            res = res.scatter(1, d_rej[:, None], 0.0)[:, :vocab]
        else:
            q_sel = torch.gather(q_t, 1, rej[..., None].expand(n_s, 1, vocab))[:, 0]
            res = (p_sel - torch.where((a < k)[:, None], q_sel, 0.0)).clamp(min=0.0)
        res = torch.where(res.sum(-1, keepdim=True) > 0, res, p_sel)
        u_res = torch.rand(res.shape, generator=self.generator, device=self.device)
        gumbel = -torch.log(-torch.log(u_res.clamp(min=1e-20)))
        repl = torch.argmax(torch.log(res) + gumbel, -1).to(tok.dtype)

        # candidates: the accepted drafts, then the correction (or bonus)
        idxs = torch.arange(c, device=self.device)[None, :]
        d_pad = torch.cat([d_t.to(tok.dtype), torch.zeros_like(tok)[:, None]], 1)
        cand = torch.where(idxs < a[:, None], d_pad, repl[:, None])
        j1 = idxs + 1
        trig = ((cand == self.eos_id) | (remaining[:, None] - j1 <= 0)
                | (pos[:, None] + j1 >= self.max_len - 1))
        can = (idxs <= a[:, None]) & active[:, None]
        hit = can & trig
        before = torch.cumsum(hit.to(torch.int32), 1) - hit.to(torch.int32)
        emit = can & (before == 0)
        n_emit = emit.to(torch.int32).sum(1, dtype=torch.int32)
        last = torch.gather(cand, 1, (n_emit - 1).clamp(min=0)[:, None].long())[:, 0]
        tok = torch.where(n_emit > 0, last, tok)
        pos = pos + n_emit
        remaining = remaining - n_emit
        active = active & ~(hit & emit).any(1)
        return tok, pos, active, remaining, cand, emit, a.to(torch.int32)

    # ------------------------------------------------------------ finish

    def _maybe_finish(self, slot: int, req: Request) -> None:
        if (req.out[-1] == self.eos_id or len(req.out) >= req.max_new
                or self.kv.full(slot)):
            self._finish(slot, req)

    def _finish(self, slot: int, req: Request) -> None:
        """Complete a request at its stop, classified as the device mask
        fired it (EOS | max_new | cache full, in that order)."""
        if req.out and req.out[-1] == self.eos_id:
            reason = "eos"
        elif len(req.out) >= req.max_new:
            reason = "max_new"
        else:
            reason = "cache_full"
        self._terminate(slot, req, reason)

    def _terminate(self, slot: int | None, req: Request, reason: str) -> None:
        """The one exit path of every request (DESIGN §16): stamp and count
        its reason, trace it, and reclaim what it held: its slot and pages
        when admitted (``slot`` given), nothing when it dies queued."""
        req.reason = reason
        req.done = True
        self._c_finished.labels(str(req.adapter_id), reason).inc()
        if self.tracer is not None:
            now = self.tracer.now()
            t_q = self._queued_ts.pop(req.rid, None)
            if t_q is not None and slot is None:
                self.tracer.span(req.rid, "queued", t_q, now)  # died queued
            self.tracer.instant(req.rid, "finish", ts=now, reason=reason,
                                tokens=len(req.out))
        if slot is not None:
            self.scheduler.complete(slot)
            self.kv.evict(slot)
