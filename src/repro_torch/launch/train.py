"""Training launcher of the port: NeuroAda sparse-bypass fine-tuning of a
dense or MoE decoder on the GPU (Alg. 1: selection, training of the bypass
values only, merged or adapter export), and the paper's baselines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --task lm --steps 200 --batch 4 --seq 512 --k 1 \\
      [--strategy magnitude|gradient|reverse|random] \\
      [--peft neuroada|lora|bitfit|masked|full [--lora-rank 8]] \\
      [--base-dtype int8|nf4 [--quant-block 64]] [--remat full|dots] \\
      [--ckpt run1/ [--resume]] [--export merged.npz] [--export-adapter tenant.npz]
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b ...
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --task lm --batch 1 --seq 4096 --k 1     # long context

Selection (Alg. 1 phase 1) runs one top-k kernel launch per adapted stack
(per layer, or per expert matrix, on a packed base). ``--strategy``:
``magnitude`` (the default), ``reverse`` (smallest |w|), ``random``
(uniform scores from a generator seeded by ``--seed``); ``gradient`` needs
a warm-up |dL/dW| the launcher does not form, so it raises the reference's
``ValueError`` (pass ``grads=`` to ``peft.neuroada`` from Python).
``--peft``: NeuroAda (the default), ``lora`` (rank ``--lora-rank``; QLoRA
on a packed base), ``bitfit``, ``masked`` (the paper's mask-based
baseline: a dense trainable copy, dense gradients and moments, the
unselected gradients masked) and ``full``; ``masked`` and ``full`` train
the dense weights and refuse a packed base, LoRA refuses the MoE family
(the reference cannot train it either), and only NeuroAda has an unmerged
adapter to export. At ``--seq`` from the
config's ``flash_threshold`` (2048) on, every layer's attention runs the
flash forward kernel and a FlashAttention-2 backward, on both families.

On the MoE family (olmoe-1b-7b) selection covers the expert stacks and the
untied head (never the router), and the loss adds ``router_aux_coef`` × the
load-balancing loss.

The weights are random from ``--seed``. ``--base-dtype int8|nf4`` packs the
frozen base after init and before selection (QLoRA-style): every adapted
projection then runs the fused dequant kernel (on MoE the expert stacks are
dequantized per call and the router stays dense), and the base never
changes a byte. ``--remat full|dots`` recomputes each layer in the backward
(``dots`` keeps the fused linears' outputs); the losses do not change.
``--ckpt DIR`` saves the values and the optimizer state every 100 steps and
at the end (``ckpt_00000100.npz``, the last three kept, written in the
background); ``--resume`` continues from the latest one, the data stream
included, and a checkpoint of either package resumes in the other.
``--export merged.npz`` writes the base with every delta folded in (dense,
also from a packed base), which ``launch/serve.py --params`` serves; the
``--export-adapter`` file serves as a tenant in either package's engine.
``--trace-out t.json`` writes every step's regions (``train.step`` and
its upload, forward, backward, optimizer and read; the MoE dispatch and
combine), host and device intervals, as Chrome trace JSON (Perfetto), or
one region a line for a ``.jsonl`` path.
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU
(for tests); the default is the GPU, and without one the launcher exits.
"""

from __future__ import annotations

import argparse
import logging

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import (
    ARCH_IDS,
    PAPER_ARCH_IDS,
    PeftConfig,
    TrainConfig,
    get_config,
    reduced,
)
from repro_torch.data import DataLoader
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.obs import Tracer
from repro_torch.peft import BASE_DTYPES, export_adapter, get_peft, quantize_base, stats
from repro_torch.quant import tree_bytes
from repro_torch.train import Trainer

log = logging.getLogger("repro_torch.launch.train")

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_IDS + PAPER_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--peft", default="neuroada",
                    choices=("neuroada", "lora", "bitfit", "masked", "full"))
    ap.add_argument("--base-dtype", default="fp32", choices=BASE_DTYPES,
                    help="pack the frozen base (QLoRA-style) before adapting")
    ap.add_argument("--quant-block", type=int, default=64,
                    help="rows per quantization scale block (d_in axis; even, >= 2)")
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--strategy", default="magnitude")
    ap.add_argument("--lora-rank", type=int, default=8)
    ap.add_argument("--task", default="reasoning", choices=("lm", "reasoning", "arithmetic"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "full", "dots"),
                    help="recompute each layer in the backward (dots keeps the "
                         "projections' outputs)")
    ap.add_argument("--ckpt", default="", help="checkpoint directory (every 100 steps)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--export", default="", help="save the merged params here")
    ap.add_argument("--export-adapter", default="",
                    help="save the unmerged (indices, values) adapter here")
    ap.add_argument("--trace-out", default="",
                    help="write the steps' regions here on exit: .jsonl = one region a line, "
                         "any other extension = Chrome trace-event JSON (Perfetto)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    return ap


def validate_args(args) -> None:
    """Reject bad values and what no method can do, before any model is
    built: a packed base under a method that trains the dense weights, an
    unmerged adapter export of a method other than NeuroAda (the
    reference's refusals), LoRA on the MoE family."""
    if args.base_dtype != "fp32" and args.peft in ("masked", "full"):
        raise SystemExit(f"--base-dtype {args.base_dtype} requires a frozen base; --peft "
                         f"{args.peft} trains the dense weights")
    if args.export_adapter and args.peft != "neuroada":
        raise SystemExit("--export-adapter requires --peft neuroada")
    if args.peft == "lora" and get_config(args.arch).num_experts:
        raise SystemExit(f"--peft lora cannot train the MoE family ({args.arch}): its expert "
                         "stacks take NeuroAda deltas only, as in the reference")
    for flag in ("k", "steps", "batch", "microbatches", "lora_rank"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag.replace('_', '-')} must be >= 1, got "
                             f"{getattr(args, flag)}")
    if args.seq < 2:
        raise SystemExit(f"--seq must be >= 2, got {args.seq}")
    if args.quant_block < 2 or args.quant_block % 2:
        raise SystemExit(f"--quant-block must be even and >= 2, got {args.quant_block}")
    if args.batch % args.microbatches:
        raise SystemExit(f"--batch {args.batch} does not split into "
                         f"{args.microbatches} microbatches")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    validate_args(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = get_model(cfg)
    params = model.init(seed=args.seed, device=device)
    if args.base_dtype != "fp32":
        before = tree_bytes(params)
        params = quantize_base(params, args.base_dtype, block=args.quant_block)
        log.info("base quantized to %s: %.1f MB -> %.1f MB (%.2fx)", args.base_dtype,
                 before / 2**20, tree_bytes(params) / 2**20, before / tree_bytes(params))
    peft = get_peft(PeftConfig(method=args.peft, k=args.k, strategy=args.strategy,
                               lora_rank=args.lora_rank))
    tcfg = TrainConfig(learning_rate=args.lr, steps=args.steps, seed=args.seed,
                       microbatches=args.microbatches, remat=args.remat,
                       checkpoint_dir=args.ckpt, checkpoint_every=100 if args.ckpt else 0)
    tracer = Tracer(device=device) if args.trace_out else None
    trainer = Trainer(model, peft, tcfg, params, tracer=tracer)
    st = stats(params, trainer.state.trainable)
    log.info("arch=%s peft=%s trainable=%s/%s (%.4f%%) device=%s", cfg.name, args.peft,
             f"{st['trainable']:,}", f"{st['total']:,}", 100 * st["fraction"], device)
    start = trainer.try_resume() if args.resume else 0
    data = DataLoader(args.task, cfg.vocab_size, args.batch, args.seq, seed=args.seed,
                      start_step=start)
    try:
        hist = trainer.run(data, steps=args.steps)
    finally:
        data.close()
    if tracer is not None:
        tracer.resolve()
        tracer.write(args.trace_out)
        log.info("trace written to %s (%d regions)", args.trace_out, len(tracer.regions))
    if hist:
        log.info("done: trainable=%s (%.4f%%) loss %.4f -> %.4f; stragglers=%d skipped=%d",
                 f"{st['trainable']:,}", 100 * st["fraction"], hist[0]["loss"],
                 hist[-1]["loss"], len(trainer.monitor.flagged), trainer.nan_guard.skipped)
    if args.export:
        save_pytree(args.export, trainer.merged_params(), {"arch": cfg.name, "peft": args.peft})
        log.info("merged params exported to %s", args.export)
    if args.export_adapter:
        # neuroada: aux is the indices tree, trainable the values tree
        export_adapter(args.export_adapter, trainer.aux, trainer.state.trainable,
                       {"arch": cfg.name, "peft": args.peft})
        log.info("unmerged adapter exported to %s", args.export_adapter)
    return hist


if __name__ == "__main__":
    main()
