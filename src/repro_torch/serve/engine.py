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

Out of the port so far: tensor parallelism, metrics and tracing,
deadlines, fairness policies and cancellation (the reference's engine has
them).
"""

from __future__ import annotations

import math

import numpy as np
import torch

import repro_torch.obs.clock as _clock
from repro_torch.core.delta import BatchedDelta
from repro_torch.device import resolve_device
from repro_torch.peft import BASE_DTYPES, quantize_base
from repro_torch.serve.adapters import AdapterStore
from repro_torch.serve.draft import DRAFT_MODES, build_draft_params
from repro_torch.serve.kv_cache import KV_DTYPES, DraftKVCache, KVCache, PagedKVCache
from repro_torch.serve.sampler import Sampler
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.tree import map_leaves

__all__ = ["Request", "ServeEngine"]


class ServeEngine:
    """The serving engine. ``paged=True`` is its default, as it is the
    reference launcher's and every caller of the port assumes; the
    reference *engine* (``repro.serve.ServeEngine``) defaults to
    ``paged=False``, so a comparison passes ``paged`` to both explicitly.
    ``page_size`` and ``num_blocks`` apply to the paged pool only."""

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
        device=None,
    ):
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
        self.scheduler = Scheduler(slots)
        self.paged = paged
        self.kv_dtype = kv_dtype
        if paged:
            if num_blocks is None:
                num_blocks = slots * -(-max_len // page_size)
            self.kv = PagedKVCache(model, slots, max_len, page_size, num_blocks, self.device,
                                   kv_dtype=kv_dtype)
        else:
            self.kv = KVCache(model, slots, max_len, self.device, kv_dtype=kv_dtype)
        self.sampler = Sampler(model.cfg.vocab_size, top_k=top_k, top_p=top_p)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.draft = draft
        self.spec_k = spec_k
        # a model drafter's params (derived once from the served ones) and
        # dense scratch; the ngram drafter needs neither
        self.draft_params = build_draft_params(self.params, draft, store=adapter_store,
                                               quant_block=quant_block)
        self.draft_kv = (None if self.draft_params is None
                         else DraftKVCache(model, slots, max_len, self.device))
        self.transfers = 0  # device-to-host fetches: one per step
        self.steps = 0
        self.preemptions = 0
        self.preemptions_mid_prefill = 0  # of them, victims still owing prompt chunks
        # drafter proposals (spec_k a live slot-round) and those accepted
        self.spec_drafted = self.spec_accepted = 0
        self.step_times: dict[str, list[float]] = {"mixed": [], "decode": [], "spec": []}
        self.emitted = {kind: 0 for kind in self.step_times}  # tokens by step kind

    @property
    def spec_emitted(self) -> int:
        """Tokens the speculative megasteps emitted."""
        return self.emitted["spec"]

    # ------------------------------------------------------------- intake

    def submit(self, prompt: list[int], max_new: int = 32, *, adapter_id: int = 0,
               temperature: float | None = None) -> int:
        """Enqueue one request; raises ValueError on a malformed one."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new <= 0:
            raise ValueError(f"max_new must be positive, got {max_new}")
        if len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} >= max_len {self.max_len}")
        n_reg = self.store.num_adapters if self.store is not None else 0
        if not 0 <= adapter_id <= n_reg:
            raise ValueError(f"adapter_id {adapter_id} not registered (have {n_reg} + base)")
        temp = self.temperature if temperature is None else temperature
        try:
            temp = float(temp)
        except (TypeError, ValueError):
            raise ValueError(f"temperature must be a finite number, got {temp!r}") from None
        if not math.isfinite(temp):
            raise ValueError(f"temperature must be a finite number, got {temp!r}")
        return self.scheduler.submit(
            prompt, max_new, adapter_id=adapter_id, temperature=temp,
            store_rev=self.store.removals if self.store is not None else 0,
        )

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
        slots; False when nothing is admitted or queued."""
        self._check_adapter_ids()
        self.scheduler.admissible(self._try_place if self.paged else None)
        if not self.scheduler.has_active():
            return False
        t0 = _clock.now()
        if self.scheduler.has_prefilling():
            kind = "mixed"
            self._chunk_step()
        elif self.draft != "off":
            kind = "spec"
            self._spec_decode_step()
        else:
            kind = "decode"
            self._decode_step()
        self.step_times[kind].append(_clock.now() - t0)
        self.steps += 1
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
        self.transfers += 1
        return bundle.cpu().numpy()

    def _adapters(self, aid: np.ndarray):
        """The step's ``{"blocks": {name: BatchedDelta}, "head": ...}``
        over the cached tenant stacks, with one adapter id per slot."""
        stacked = self.store.stacked(self.device) if self.store is not None else None
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
        for s, req in enumerate(self.scheduler.active):
            if req is None:
                continue
            take = int(plan["q_len"][s])
            if take and req.mid_prefill:
                req.prefilled += take
                if self.paged:
                    self.kv.mark_prefilled(s, req.prefilled)
            if plan["emit"][s]:
                req.out.append(int(toks[s]))
                self.emitted["mixed"] += 1
                self._maybe_finish(s, req)

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
        self.preemptions += 1
        self.preemptions_mid_prefill += req.mid_prefill
        self.scheduler.preempt(victim)
        self.kv.evict(victim)

    def _decode_step(self) -> None:
        """Decode megastep: up to ``decode_chunk`` tokens per slot with the
        token, position, budget and active mask carried on the device."""
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
        self.kv.sync(pos, pos_np)
        for t in range(c):
            for s, req in enumerate(self.scheduler.active):
                if req is not None and emits_np[t, s]:
                    req.out.append(int(toks_np[t, s]))
                    self.emitted["decode"] += 1
        for s, req in enumerate(self.scheduler.active):
            if req is not None and not active_np[s]:
                self._finish(s, req)

    # --------------------------------------------------- speculative decode

    def _spec_decode_step(self) -> None:
        """Speculative decode megastep: ``decode_chunk`` draft / verify /
        accept rounds over all active slots, then the (round, slot, K + 1)
        emissions replayed into the requests from one fetched bundle."""
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
        self.kv.sync(bundle[:n], pos_np)
        for t in range(r):
            for s, req in enumerate(self.scheduler.active):
                if req is None:
                    continue
                if lives[t, s]:
                    req.spec_drafted += self.spec_k
                    req.spec_accepted += int(accs[t, s])
                    self.spec_drafted += self.spec_k
                    self.spec_accepted += int(accs[t, s])
                for j in range(c):
                    if emits[t, s, j]:
                        req.out.append(int(toks[t, s, j]))
                        self.emitted["spec"] += 1
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
        """Complete a request at its stop (EOS | max_new | cache full, in
        that order) and free its slot and pages."""
        if req.out and req.out[-1] == self.eos_id:
            req.reason = "eos"
        elif len(req.out) >= req.max_new:
            req.reason = "max_new"
        else:
            req.reason = "cache_full"
        req.done = True
        self.scheduler.complete(slot)
        self.kv.evict(slot)
