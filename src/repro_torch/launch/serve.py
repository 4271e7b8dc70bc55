"""Serving launcher of the port: one base model, N tenants, multi-tenant
batched serving on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --prompts "1,17,25;1,40,41" --max-new 16 [--adapters a.npz,b.npz]

Adapters are npz files from either package's ``export_adapter``; requests
cycle through the tenants unless ``--adapter-ids`` pins them (0 = base).
``--base-dtype int8|nf4`` serves every tenant off one packed base (every
base matmul through the fused dequant kernel); ``--quant-block`` must match
the block the adapters were trained against. The engine runs on the paged
KV pool (``--paged``, the default) or, with ``--dense``, on the dense slot
cache; ``--kv-dtype int8`` stores either as int8 codes with float32 scales.
``--arch olmoe-1b-7b`` serves the MoE family (tenants' expert and head
deltas through the expert dispatch); ``--base-dtype int8|nf4`` and
``--kv-dtype int8`` are not ported on MoE yet and raise.
The weights are random from seed 0 (weight files are not loaded yet).
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU
(for tests); the default is the GPU, and without one the launcher exits.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, PAPER_ARCH_IDS, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.peft import BASE_DTYPES, load_adapter, quantize_base
from repro_torch.quant import tree_bytes
from repro_torch.serve import KV_DTYPES, AdapterStore, ServeEngine


def validate_args(args) -> None:
    """Reject bad flag combinations before any model is built."""
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
    prompts = [p for p in args.prompts.split(";") if p]
    if not prompts:
        raise SystemExit("--prompts holds no prompt")
    for p in prompts:
        if not any(t.strip() for t in p.split(",")):
            raise SystemExit(f"--prompts entry {p!r} holds no token ids")
    if args.quant_block < 2 or args.quant_block % 2:
        raise SystemExit(f"--quant-block must be even and >= 2, got {args.quant_block}")
    if args.kv_dtype not in KV_DTYPES:
        raise SystemExit(f"--kv-dtype {args.kv_dtype!r} must be one of {', '.join(KV_DTYPES)}")
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
    if args.adapter_ids:
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
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    validate_args(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = get_model(cfg)
    params = model.init(seed=0, device=device)
    if args.base_dtype != "fp32":
        before = tree_bytes(params)
        params = quantize_base(params, args.base_dtype, block=args.quant_block)
        print(f"base quantized to {args.base_dtype}: "
              f"{before / 2**20:.1f} MB -> {tree_bytes(params) / 2**20:.1f} MB")
    store = None
    if args.adapters:
        store = AdapterStore(base_params=params)
        for path in args.adapters.split(","):
            print(f"tenant {store.register(*load_adapter(path), name=path)}: {path}")
    engine = ServeEngine(
        model, params, slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        adapter_store=store, decode_chunk=args.decode_chunk,
        prefill_chunk=args.prefill_chunk,
        page_size=16 if args.page_size is None else args.page_size,
        num_blocks=args.num_blocks, paged=not args.dense, kv_dtype=args.kv_dtype,
        device=device,
    )
    prompts = [p for p in args.prompts.split(";") if p]
    n_tenants = store.num_adapters if store is not None else 0
    if args.adapter_ids:
        ids = [int(t) for t in args.adapter_ids.split(",")]
    else:
        ids = [1 + i % n_tenants if n_tenants else 0 for i in range(len(prompts))]
    for p, aid in zip(prompts, ids):
        engine.submit([int(t) for t in p.split(",") if t.strip()], max_new=args.max_new,
                      adapter_id=aid)
    for req in engine.run_to_completion():
        tenant = "base" if req.adapter_id == 0 else f"tenant{req.adapter_id}"
        print(f"req{req.rid} [{tenant}]: prompt={req.prompt} -> {req.out}")
    layout = "paged" if engine.paged else "dense"
    print(f"steps={engine.steps} transfers={engine.transfers} "
          f"preemptions={engine.preemptions} kv={layout}/{engine.kv_dtype} "
          f"pool_bytes={engine.kv.pool_bytes()} device={device}")


if __name__ == "__main__":
    main()
