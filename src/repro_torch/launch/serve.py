"""Serving launcher of the port: one base model, N tenants, multi-tenant
batched serving on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --prompts "1,17,25;1,40,41" --max-new 16 [--adapters a.npz,b.npz]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --params merged.npz --prompts "1,17,25"     # a merged export, one tenant

Adapters are npz files from either package's ``export_adapter``; requests
cycle through the tenants unless ``--adapter-ids`` pins them (0 = base).
``--base-dtype int8|nf4`` serves every tenant off one packed base (every
base matmul through the fused dequant kernel); ``--quant-block`` must match
the block the adapters were trained against. The engine runs on the paged
KV pool (``--paged``, the default) or, with ``--dense``, on the dense slot
cache; ``--kv-dtype int8`` stores either as int8 codes with float32 scales.
``--arch olmoe-1b-7b`` serves the MoE family (tenants' expert and head
deltas through the expert dispatch), on any base and KV cache.
``--draft int8|nf4|merged|ngram`` turns on speculative decoding: a drafter
proposes ``--spec-k`` tokens a slot a round and the served model verifies
them in one chunk; greedy outputs equal ``--draft off``'s. ``merged`` needs
``--adapters``.
``--params`` serves the npz of either package's ``train --export`` (or a
tree written by ``repro_torch.checkpoint.save_pytree``, e.g. from
``convert.py``), moved to the device in its stored dtypes;
``--base-dtype`` and ``--adapters`` then apply on top of it. Without it
the weights are random from seed 0.
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU
(for tests); the default is the GPU, and without one the launcher exits.

Observability (DESIGN §13): ``--metrics-out m.prom`` (Prometheus text;
``.json`` for the snapshot) and ``--trace-out t.json`` (Chrome trace-event
JSON; ``.jsonl`` for one event a line) dump the run's metrics and request
trace on exit; ``--metrics-every N`` prints a one-line digest every N steps;
``--profile-dir d`` runs the batch under ``torch.profiler`` (CPU and, on
the card, CUDA activities) and writes its Chrome trace into ``d``. None of
it adds a device operation to a step.

``--tp N`` serves tensor-parallel over N ranks, one process each: this
process is rank 0, the leader, and spawns the N - 1 followers
(``torch.multiprocessing``, spawn context) that meet it at a ``file://``
rendezvous in a temporary directory (no TCP port). Rank r runs on
``cuda:r`` (N must divide the local GPUs, as the reference's
``make_serve_mesh`` requires) or, under ``--device cpu``, on the CPU with
gloo collectives. Each rank builds the same model and tenants and keeps its
slices (:mod:`repro_torch.distributed.sharding`); the leader's engine
drives the followers' steps (:class:`~repro_torch.serve.ServeEngine`),
prints the tokens and ends the followers when it is done (under
``--serve``, after ``POST /admin/shutdown`` drained it). Greedy tokens
equal ``--tp 1``'s.

``--serve [--port P]`` runs the SSE front end instead of a batch
(:class:`~repro_torch.serve.ServeFrontend`: ``POST /v1/generate``,
``/v1/cancel``, ``GET /metrics``, ``/healthz``, ``POST /admin/shutdown``);
``--queue-limit`` bounds its backlog and ``--fairness drr`` admits tenants
in deficit round robin.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import ARCH_IDS, PAPER_ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import close_tp, device_backend, init_tp
from repro_torch.models import get_model
from repro_torch.obs import Tracer
from repro_torch.peft import BASE_DTYPES, load_adapter, quantize_base
from repro_torch.quant import tree_bytes
from repro_torch.serve import (
    DRAFT_MODES,
    KV_DTYPES,
    POLICIES,
    AdapterStore,
    ServeEngine,
    ServeFrontend,
)
from repro_torch.tree import map_leaves


def validate_args(args) -> None:
    """Reject bad flag combinations before any model is built; every
    refusal the reference's launcher makes, with its words, and a few of
    the port's own."""
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if args.decode_chunk < 1:
        raise SystemExit(f"--decode-chunk must be >= 1, got {args.decode_chunk}")
    if args.prefill_chunk < 1:
        raise SystemExit(f"--prefill-chunk must be >= 1, got {args.prefill_chunk}")
    if args.max_new < 1:
        raise SystemExit(f"--max-new must be >= 1, got {args.max_new}")
    if args.slots < 1:
        raise SystemExit(f"--slots must be >= 1, got {args.slots}")
    if args.max_len < 2:
        raise SystemExit(f"--max-len must be >= 2, got {args.max_len}")
    if args.top_k < 0:
        raise SystemExit(f"--top-k must be >= 0, got {args.top_k}")
    if not 0.0 <= args.top_p <= 1.0:
        raise SystemExit(f"--top-p must be in [0, 1], got {args.top_p}")
    if args.temperature < 0:
        raise SystemExit(f"--temperature must be >= 0, got {args.temperature}")
    if args.quant_block < 2 or args.quant_block % 2:
        raise SystemExit(f"--quant-block must be even and >= 2, got {args.quant_block}")
    if args.draft not in DRAFT_MODES:
        raise SystemExit(f"--draft {args.draft!r} must be one of {', '.join(DRAFT_MODES)}")
    if args.spec_k < 1:
        raise SystemExit(f"--spec-k must be >= 1, got {args.spec_k}")
    if args.kv_dtype not in KV_DTYPES:
        raise SystemExit(f"--kv-dtype {args.kv_dtype!r} must be one of {', '.join(KV_DTYPES)}")
    if args.draft == "merged" and not args.adapters:
        raise SystemExit(
            "--draft merged drafts with the mean of the registered tenants "
            "and so needs --adapters; use --draft int8/nf4 for a "
            "single-model (quantized self-draft) setup")
    if args.metrics_every < 0:
        raise SystemExit(f"--metrics-every must be >= 0, got {args.metrics_every}")
    if args.port is not None:
        if not args.serve:
            raise SystemExit("--port needs --serve")
        if not 0 <= args.port <= 65535:
            raise SystemExit(f"--port must be in [0, 65535], got {args.port}")
    if args.queue_limit is not None and args.queue_limit < 1:
        raise SystemExit(f"--queue-limit must be >= 1, got {args.queue_limit}")
    if args.fairness not in POLICIES:
        raise SystemExit(f"--fairness {args.fairness!r} must be one of {', '.join(POLICIES)}")
    prompts = [p for p in args.prompts.split(";") if p]
    for p in prompts:
        if not any(t.strip() for t in p.split(",")):
            raise SystemExit(f"--prompts entry {p!r} holds no token ids")
    if not prompts and not args.serve:
        for flag, val in (("--metrics-out", args.metrics_out), ("--trace-out", args.trace_out),
                          ("--profile-dir", args.profile_dir)):
            if val:
                raise SystemExit(f"{flag} needs a serve run to observe; --prompts is empty")
        raise SystemExit("--prompts holds no prompt")
    if args.profile_dir:
        parent = os.path.dirname(os.path.abspath(args.profile_dir))
        if not os.path.isdir(parent):
            raise SystemExit(f"--profile-dir parent {parent!r} does not exist")
    for flag, path in (("--metrics-out", args.metrics_out), ("--trace-out", args.trace_out)):
        if path:
            parent = os.path.dirname(os.path.abspath(path))
            if not os.path.isdir(parent):
                raise SystemExit(f"{flag} parent {parent!r} does not exist")
    _validate_adapter_ids(args, prompts)
    if args.dense:
        if args.paged:
            raise SystemExit("--paged and --dense are mutually exclusive")
        if args.page_size is not None:
            raise SystemExit("--page-size is a paged-engine flag; drop --dense")
        if args.num_blocks is not None:
            raise SystemExit("--num-blocks is a paged-engine flag; drop --dense")
        return
    page = 16 if args.page_size is None else args.page_size
    if page < 1 or page & (page - 1):
        raise SystemExit(f"--page-size must be a power of two, got {page}")
    min_blocks = -(-args.max_len // page)
    if args.num_blocks is not None and args.num_blocks < min_blocks:
        raise SystemExit(
            f"--num-blocks {args.num_blocks} cannot hold one max-length request: "
            f"--max-len {args.max_len} needs {min_blocks} pages of {page}")


def _validate_adapter_ids(args, prompts) -> None:
    if args.adapter_ids and not args.serve:
        n_ids = len(args.adapter_ids.split(","))
        if n_ids != len(prompts):
            raise SystemExit(f"--adapter-ids has {n_ids} entries for {len(prompts)} prompts")
        n_tenants = len(args.adapters.split(",")) if args.adapters else 0
        for t in args.adapter_ids.split(","):
            if not t.strip().isdigit() or int(t) > n_tenants:
                raise SystemExit(f"--adapter-ids entry {t!r} is not in 0..{n_tenants}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS + PAPER_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--params", default="", help="npz from train --export")
    ap.add_argument("--prompts", default="1,17,25;1,40,41,42",
                    help="';'-separated prompts of ','-separated token ids")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens per slot per decode megastep")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="prompt tokens per mixed step across all slots")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool: block pool + block tables + shared-prefix "
                         "reuse (the default; conflicts with --dense)")
    ap.add_argument("--dense", action="store_true",
                    help="dense slots x max_len KV cache")
    ap.add_argument("--page-size", type=int, default=None,
                    help="tokens per KV block (paged; default 16)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks (paged; default slots × max pages)")
    ap.add_argument("--kv-dtype", default="fp32", choices=KV_DTYPES,
                    help="KV cache storage: fp32 (the model's dtype) or int8 codes with "
                         "per-page (paged) or per-16-row-group (dense) float32 scales")
    ap.add_argument("--adapters", default="",
                    help="comma-separated adapter npz files, tenants 1..N")
    ap.add_argument("--adapter-ids", default="",
                    help="comma-separated adapter id per prompt (default: cycle)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0)
    ap.add_argument("--base-dtype", default="fp32", choices=BASE_DTYPES,
                    help="serve every tenant off one packed (int8/nf4) frozen base")
    ap.add_argument("--quant-block", type=int, default=64,
                    help="rows per scale block; must match the --quant-block the "
                         "adapters were trained against")
    ap.add_argument("--draft", default="off",
                    help="speculative decoding drafter: int8/nf4 = the packed base as a "
                         "self-draft, merged = base + mean of the tenants' deltas (needs "
                         "--adapters), ngram = prompt lookup (no drafter forwards); "
                         "one of " + ", ".join(DRAFT_MODES))
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks, one process each: base weights Megatron-split, "
                         "the KV pool split along kv-heads (per-shard pool bytes = total / tp), "
                         "greedy outputs identical to --tp 1. Must divide the local GPUs (or "
                         "run with --device cpu) and the model's head counts")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens a slot a speculative round")
    ap.add_argument("--metrics-out", default="",
                    help="dump the metrics registry here on exit: .json = snapshot (with "
                         "histogram p50/p95), any other extension = Prometheus text")
    ap.add_argument("--trace-out", default="",
                    help="dump the request-lifecycle trace here on exit: .jsonl = one event "
                         "a line, any other extension = Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="print a one-line metrics digest every N serve steps (0 = off)")
    ap.add_argument("--profile-dir", default="",
                    help="run the batch under torch.profiler (CPU and CUDA activities) and "
                         "write its Chrome trace into this directory")
    ap.add_argument("--serve", action="store_true",
                    help="run the SSE front end instead of a batch: POST /v1/generate, "
                         "/v1/cancel, GET /metrics, /healthz, POST /admin/shutdown drains; "
                         "--prompts is ignored")
    ap.add_argument("--port", type=int, default=None,
                    help="front-end TCP port (needs --serve; 0 = ephemeral, default 8000)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bound the admission backlog: submits past it are shed (HTTP 503 + "
                         "Retry-After under --serve, QueueFullError from the API)")
    ap.add_argument("--fairness", default="fifo",
                    help="admission policy: fifo = global arrival order, drr = per-tenant "
                         "deficit round robin; one of " + ", ".join(POLICIES))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    return ap


def _metrics_line(engine, step: int) -> str:
    """One-line digest of the live registry for ``--metrics-every``."""
    v = engine.metrics.value
    fin = engine.metrics.get("serve_requests_finished_total")
    sub = engine.metrics.get("serve_requests_submitted_total")
    line = (f"[metrics] step={step} finished={int(fin.total)}/{int(sub.total)}"
            f" queue={int(v('serve_queue_depth'))} active={int(v('serve_slots_active'))}"
            f" transfers={int(v('serve_transfers_total'))}"
            f" compiles={int(v('serve_jit_compiles'))}")
    if engine.paged:
        used = int(v("serve_pool_blocks_used"))
        line += f" pool={used}/{used + int(v('serve_pool_blocks_free'))}"
    return line


#: seconds the leader waits for each follower to exit after its shutdown
FOLLOWER_JOIN_SECONDS = 60.0


def _validate_tp(args, cfg, device) -> None:
    """``--tp`` against the devices and the model's heads, with the
    reference launcher's words, before any model is built."""
    if device.type == "cuda":
        n = torch.cuda.device_count()
        if n % args.tp:
            raise SystemExit(f"--tp {args.tp}: tp={args.tp} does not divide the {n} local "
                             "devices")
    for name, heads in (("num_kv_heads", cfg.num_kv_heads), ("num_heads", cfg.num_heads)):
        if heads % args.tp:
            raise SystemExit(f"--tp {args.tp} does not divide {name}={heads} for "
                             f"--arch {args.arch}")


def _rank_device(device, rank: int):
    return device if device.type == "cpu" else torch.device("cuda", rank)


def _engine(args, device, tp_group=None, *, quiet: bool = False):
    """(engine, tracer) of the flags: the model, its weights, the packed
    base and the tenants, on ``device``; with ``tp_group``, one rank's
    slices. ``quiet`` (a follower rank) prints nothing."""
    say = (lambda *a: None) if quiet else print
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = get_model(cfg)
    if args.params:
        params = map_leaves(lambda t: None if t is None else t.to(device),
                            load_pytree(args.params))
    else:
        params = model.init(seed=0, device=device)
    if args.base_dtype != "fp32":
        before = tree_bytes(params)
        params = quantize_base(params, args.base_dtype, block=args.quant_block)
        say(f"base quantized to {args.base_dtype}: "
            f"{before / 2**20:.1f} MB -> {tree_bytes(params) / 2**20:.1f} MB")
    store = None
    if args.adapters:
        store = AdapterStore(base_params=params)
        for path in args.adapters.split(","):
            say(f"tenant {store.register(*load_adapter(path), name=path)}: {path}")
    tracer = Tracer() if args.trace_out else None
    engine = ServeEngine(
        model, params, slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        adapter_store=store, decode_chunk=args.decode_chunk,
        prefill_chunk=args.prefill_chunk,
        page_size=16 if args.page_size is None else args.page_size,
        num_blocks=args.num_blocks, paged=not args.dense, kv_dtype=args.kv_dtype,
        draft=args.draft, spec_k=args.spec_k, tracer=tracer,
        queue_limit=args.queue_limit, fairness=args.fairness, device=device,
        tp_group=tp_group,
    )
    return engine, tracer


def _follower(argv, rank: int, init_method: str) -> None:
    """A follower rank's process: join the group, build the same engine and
    run the leader's steps until its shutdown record."""
    args = build_parser().parse_args(argv)
    device = _rank_device(resolve_device(args.device), rank)
    group = init_tp(rank, args.tp, device, init_method)
    try:
        engine, _ = _engine(args, device, group, quiet=True)
        engine.follow()
    finally:
        close_tp()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    validate_args(args)
    device = resolve_device(args.device)
    if args.tp == 1:
        _lead(args, device)
        return
    cfg = get_config(args.arch)
    _validate_tp(args, reduced(cfg) if args.reduced else cfg, device)
    device = _rank_device(device, 0)
    print(f"serving tensor-parallel over {args.tp} shards "
          f"({device_backend(device, args.tp)} collectives, rank 0 on {device})", flush=True)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_follower, args=(argv, r, init_method))
                 for r in range(1, args.tp)]
        for p in procs:
            p.start()
        try:
            group = init_tp(0, args.tp, device, init_method)
            try:
                _lead(args, device, group)
            finally:
                close_tp()
        finally:
            for p in procs:
                p.join(FOLLOWER_JOIN_SECONDS)
                if p.is_alive():
                    p.terminate()
                    p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"tensor-parallel follower ranks exited with {codes}")


def _lead(args, device, tp_group=None) -> None:
    """The batch or the server on this process's engine (the leader's
    under ``--tp``, which ends its followers when it is done; after a
    failure the group's teardown fails their next collective instead)."""
    engine, tracer = _engine(args, device, tp_group)
    _run(engine, tracer, args)
    engine.close()


def _run(engine, tracer, args) -> None:
    device, store = engine.device, engine.store
    if args.serve:
        _serve_http(engine, args, tracer)
        return
    prompts = [p for p in args.prompts.split(";") if p]
    n_tenants = store.num_adapters if store is not None else 0
    if args.adapter_ids:
        ids = [int(t) for t in args.adapter_ids.split(",")]
    else:
        ids = [1 + i % n_tenants if n_tenants else 0 for i in range(len(prompts))]
    for p, aid in zip(prompts, ids):
        engine.submit([int(t) for t in p.split(",") if t.strip()], max_new=args.max_new,
                      adapter_id=aid)
    reqs = engine.scheduler.in_flight()
    with _profiled(args.profile_dir, device):
        steps = 0
        while engine.step():
            steps += 1
            if args.metrics_every and steps % args.metrics_every == 0:
                print(_metrics_line(engine, steps))
    for req in reqs:
        tenant = "base" if req.adapter_id == 0 else f"tenant{req.adapter_id}"
        print(f"req{req.rid} [{tenant}]: prompt={req.prompt} -> {req.out}")
    layout = "paged" if engine.paged else "dense"
    shards = (f" tp={engine.tp} pool_bytes_per_shard={engine.kv.pool_bytes_per_shard()}"
              if engine.tp > 1 else "")
    print(f"steps={engine.steps} transfers={engine.transfers} "
          f"preemptions={engine.preemptions} kv={layout}/{engine.kv_dtype} "
          f"pool_bytes={engine.kv.pool_bytes()}{shards} device={device}")
    if args.draft != "off":
        rate = engine.spec_accepted / max(engine.spec_drafted, 1)
        print(f"spec[{args.draft} k={args.spec_k}]: drafted={engine.spec_drafted} "
              f"accepted={engine.spec_accepted} ({rate:.0%}) emitted={engine.spec_emitted}")
    _dump_obs(engine, tracer, args)


@contextlib.contextmanager
def _profiled(profile_dir: str, device):
    """``--profile-dir``: the batch under ``torch.profiler`` (CPU activity,
    and CUDA on the card), its Chrome trace written into ``profile_dir``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "serve_trace.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")


def _dump_obs(engine, tracer, args) -> None:
    """Flush --metrics-out / --trace-out (after the drain in serve mode, so
    the dumps cover every request the server handled)."""
    if args.metrics_out:
        text = (engine.metrics.dump_json() if args.metrics_out.endswith(".json")
                else engine.metrics.expose())
        with open(args.metrics_out, "w") as f:
            f.write(text)
        print(f"metrics written to {args.metrics_out}")
    if args.trace_out:
        tracer.write(args.trace_out)
        print(f"trace written to {args.trace_out} ({len(tracer)} events)")


def _serve_http(engine, args, tracer) -> None:
    """--serve: run the SSE front end until a graceful shutdown (POST
    /admin/shutdown or Ctrl-C) drains the engine."""
    front = ServeFrontend(engine, port=8000 if args.port is None else args.port)

    async def run():
        port = await front.start()
        print(f"serving on http://{front.host}:{port} "
              f"(POST /v1/generate streams SSE; POST /admin/shutdown drains)", flush=True)
        try:
            await front.serve()
        except KeyboardInterrupt:
            await front.shutdown()
            await front.serve()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    print("server drained")
    _dump_obs(engine, tracer, args)


if __name__ == "__main__":
    main()
