"""Batched serving on the paged KV core of the port (twin of the
reference's ``examples/serve_batched.py``): block-pool cache, block-aware
continuous batching, chunked prefill fused into the serving step,
multi-tenant adapters — staggered request arrival, shared-prefix reuse,
per-slot NeuroAda deltas, all off ONE int8-packed frozen base — then the
same workload again under speculative decoding with the merged
mean-of-tenants drafter (the CLI twin is ``python -m
repro_torch.launch.serve --base-dtype int8 --prefill-chunk 16 --adapters …
[--draft merged --spec-k 4]``). The whole run is observed through the
metrics registry and the request-lifecycle tracer, with the per-tenant
token split and the pool / prefix series read back from the registry at
the end (CLI twin: ``--metrics-out metrics.prom --trace-out trace.json``,
then load trace.json in Perfetto).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.adapt import init_adapters
from repro_torch.device import resolve_device
from repro_torch.examples.common import synchronize
from repro_torch.models import get_model
from repro_torch.obs import Tracer
from repro_torch.peft import quantize_base
from repro_torch.quant import tree_bytes
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.tree import map_leaves

SYSTEM = list(range(1, 17))  # 16-token "system prompt" = 1 full page
PROMPTS = [
    SYSTEM + [10, 11, 12],
    SYSTEM + [20, 21],
    SYSTEM + [30, 31, 32, 33, 34],
    [1, 40],
    [1, 50, 51, 52],
    [1, 60, 61],
]
# the three system-prompted requests belong to tenant1 — their shared page
# dedups (reuse is per tenant: deltas change k/v); the rest interleave
# tenant2 and the base model
IDS = [1, 1, 1, 0, 2, 0]


def config():
    return reduced(get_config("qwen2.5-3b")).replace(num_layers=4)


def random_tenants(params, device) -> list:
    """Two tenants: magnitude top-2 indices on the packed base, values
    ``0.05 · normal`` drawn from a generator seeded 1 and 2 (random values
    stand in for training — see ``launch/train.py --export-adapter`` for
    the real artifact)."""
    out = []
    for seed in (1, 2):
        gen = torch.Generator(device=device).manual_seed(seed)
        idx, val = init_adapters(params, 2, rng=gen)
        val = map_leaves(lambda v: None if v is None else 0.05 * torch.randn(
            v.shape, generator=gen, device=device), val)
        out.append((idx, val))
    return out


def run(cfg, params, tenants=None, *, device=None) -> dict:
    """Pack ``params`` (dense, ``cfg``'s, on ``device``) to int8, register
    the two ``tenants`` (``(indices, values)`` trees on the packed base;
    drawn by :func:`random_tenants` when None), serve the six prompts on
    the paged int8-KV engine, then again with the merged drafter. Returns
    every number printed."""
    dev = resolve_device(device)
    model = get_model(cfg)
    out = {}
    # every tenant shares one quantized base: 4x less weight memory per box
    out["dense_bytes"] = tree_bytes(params)
    params = quantize_base(params, "int8")
    out["packed_bytes"] = tree_bytes(params)
    print(f"base weights: {out['dense_bytes']/2**20:.2f} MB dense -> "
          f"{out['packed_bytes']/2**20:.2f} MB int8")

    # two tenants: unmerged (indices, values) deltas over one frozen base
    store = AdapterStore(base_params=params)  # validates idx vs base shapes
    if tenants is None:
        tenants = random_tenants(params, dev)
    for seed, (idx, val) in zip((1, 2), tenants):
        store.register(idx, val, name=f"tenant{seed}")

    # paged KV: 6 slots share a 32-block pool (512 tokens) — a dense cache
    # at this concurrency would pre-reserve 6 × 128 = 768 rows. Requests
    # with a common page-aligned prompt prefix (same tenant) dedup their
    # leading pages against refcounted shared blocks. Prompts are consumed
    # 16 tokens per mixed step (--prefill-chunk): a long prompt never
    # stalls the other streams' decode, and later same-prefix arrivals
    # skip chunk-walking the pages that are already resident.
    # kv_dtype="int8" quantizes the pool itself: pages store int8 codes +
    # per-(page, kv-head) scales, attention dequantizes in the kernel, and
    # the same byte budget funds about 4x the pooled tokens (CLI twin:
    # serve --kv-dtype int8) — composing with the int8 base above so both
    # weights AND cache ride the quantized path.
    engine = ServeEngine(model, params, slots=6, max_len=128,
                         adapter_store=store, decode_chunk=8,
                         prefill_chunk=16,
                         paged=True, page_size=16, num_blocks=32,
                         kv_dtype="int8",
                         metrics=True, tracer=Tracer(), device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    for p, aid in zip(PROMPTS, IDS):
        engine.submit(p, max_new=16, adapter_id=aid)
    # chunked admission: the system-prompt *writer* lands its pages first
    # (mixed steps), then the same-tenant twins admit against the written
    # prefix and skip straight to their private tails
    steps = 0
    while engine.scheduler.has_queued() or engine.scheduler.has_prefilling():
        engine.step()
        steps += 1
    kv = engine.kv
    out.update(admit_steps=steps, used_blocks=kv.used_blocks, num_blocks=kv.num_blocks,
               page_size=kv.page_size, shared_pages=int((kv.refcount > 1).sum()))
    print(f"in flight after {steps} mixed steps: "
          f"{kv.used_blocks}/{kv.num_blocks} blocks "
          f"({kv.used_blocks * kv.page_size} of {kv.num_blocks * kv.page_size} "
          f"pooled tokens), shared pages: "
          f"{out['shared_pages']} (refcounted prefix reuse)")
    reqs = engine.run_to_completion()
    synchronize(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    out.update(requests=len(reqs), tokens=total_tokens, seconds=dt,
               tok_per_s=total_tokens / dt, free_blocks=kv.free_blocks,
               transfers=engine.transfers, steps=engine.steps)
    print(f"{len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {dev.type}), "
          f"pool drained: {kv.free_blocks}/{kv.num_blocks} free")
    out["outs"], out["tenants"] = {}, {}
    for r in reqs:
        tenant = "base" if r.adapter_id == 0 else store.names[r.adapter_id - 1]
        out["outs"][r.rid], out["tenants"][r.rid] = list(r.out), tenant
        print(f"  req{r.rid} [{tenant}] prompt={r.prompt} -> {r.out}")

    # the observability layer saw all of it: per-tenant token split, prefix
    # dedup and latency quantiles from the registry, the per-request
    # lifecycle (admission, chunked prefill, preempt / re-prefill, finish)
    # from the tracer — with no extra device transfer
    reg = engine.metrics
    out["split"] = {t: int(reg.value("serve_tenant_tokens_total", t)) for t in ("0", "1", "2")}
    out.update(prefix_hit=int(reg.value("serve_prefix_pages_hit_total")),
               prefix_fresh=int(reg.value("serve_prefix_pages_fresh_total")),
               ttft_p50_ms=reg.get("serve_ttft_seconds").quantile(0.5) * 1e3,
               trace_events=len(engine.tracer))
    print(f"tenant token split {out['split']}, prefix pages "
          f"hit={out['prefix_hit']} fresh={out['prefix_fresh']}, "
          f"ttft p50 {out['ttft_p50_ms']:.1f}ms, {out['trace_events']} trace events "
          f"(Tracer.write('trace.json') -> Perfetto)")

    # same workload with speculative decoding: the merged drafter (base +
    # mean of the two tenants' deltas, adapter-free forward) proposes 4
    # tokens per round and the full model verifies them in one batched
    # chunk pass. The twin keeps kv_dtype="int8" so the comparison stays
    # apples-to-apples; verify writes land in wider chunks than plain
    # decode, so int8 outputs agree on most tokens but are not guaranteed
    # bit-identical. The pool must fund the wider reserve horizon
    # decode_chunk * (k + 1) (CLI twin: serve --draft merged --spec-k 4
    # --kv-dtype int8 …)
    spec = ServeEngine(model, params, slots=6, max_len=128,
                       adapter_store=store, decode_chunk=8,
                       prefill_chunk=16, paged=True, page_size=16,
                       num_blocks=48, draft="merged", spec_k=4,
                       kv_dtype="int8", device=dev)
    for p, aid in zip(PROMPTS, IDS):
        spec.submit(p, max_new=16, adapter_id=aid)
    synchronize(dev)
    t0 = time.perf_counter()
    spec_reqs = spec.run_to_completion()
    synchronize(dev)
    dt_spec = time.perf_counter() - t0
    agree = sum(
        a == b
        for rs, rp in zip(spec_reqs, reqs)
        for a, b in zip(rs.out, rp.out)
    ) / max(sum(len(r.out) for r in reqs), 1)
    rate = spec.spec_accepted / max(spec.spec_drafted, 1)
    out.update(agreement=agree, spec_accepted=spec.spec_accepted,
               spec_drafted=spec.spec_drafted, spec_rate=rate,
               spec_tokens=sum(len(r.out) for r in spec_reqs), spec_seconds=dt_spec,
               spec_outs={r.rid: list(r.out) for r in spec_reqs},
               spec_transfers=spec.transfers, spec_steps=spec.steps)
    print(f"speculative twin: token agreement {agree:.0%}, "
          f"{spec.spec_accepted}/{spec.spec_drafted} drafts accepted "
          f"({rate:.0%}), {out['spec_tokens']} tokens "
          f"in {dt_spec:.2f}s")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config()
    params = get_model(cfg).init(seed=0, device=dev)
    return run(cfg, params, device=dev)


if __name__ == "__main__":
    main()
