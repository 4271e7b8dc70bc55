"""Training launcher of the port: NeuroAda sparse-bypass fine-tuning of a
dense or MoE decoder on the GPU (Alg. 1: magnitude selection, training of
the bypass values only, adapter export).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --task lm --steps 200 --batch 4 --seq 512 --k 1 \\
      [--base-dtype int8|nf4 [--quant-block 64]] [--export-adapter tenant.npz]
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b ...

On the MoE family (olmoe-1b-7b) selection covers the expert stacks and the
untied head (never the router), the loss adds ``router_aux_coef`` × the
load-balancing loss, and ``--base-dtype int8|nf4`` is not ported yet.

The weights are random from ``--seed`` (weight files are not loaded yet).
``--base-dtype int8|nf4`` packs the frozen base after init and before
selection (QLoRA-style): every adapted projection then runs the fused
dequant kernel, and the base never changes a byte.
The exported adapter serves as a tenant in either package's engine.
``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU
(for tests); the default is the GPU, and without one the launcher exits.
Flags of the reference launcher that the port does not have yet are
accepted only at their defaults and otherwise raise.
"""

from __future__ import annotations

import argparse
import logging

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
from repro_torch.peft import BASE_DTYPES, export_adapter, get_peft, quantize_base, stats
from repro_torch.quant import tree_bytes
from repro_torch.train import Trainer

log = logging.getLogger("repro_torch.launch.train")

# flag -> (default, the ROADMAP.md item that brings it)
NOT_YET = {
    "peft": ("neuroada", "§1 item 9, remaining PEFT methods"),
    "strategy": ("magnitude", "§1 item 9, remaining selection strategies"),
    "remat": ("none", "§1, remat"),
    "ckpt": ("", "§1, checkpoint/resume"),
    "resume": (False, "§1, checkpoint/resume"),
    "export": ("", "§1, merged export"),
}


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
    ap.add_argument("--task", default="reasoning", choices=("lm", "reasoning", "arithmetic"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=("none", "full", "dots"))
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--export", default="", help="merged params (not ported yet)")
    ap.add_argument("--export-adapter", default="",
                    help="save the unmerged (indices, values) adapter here")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    return ap


def validate_args(args) -> None:
    """Reject what the port does not have yet, and bad values, before any
    model is built."""
    for flag, (default, item) in NOT_YET.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} {getattr(args, flag)!r} is not ported yet "
                f"(ROADMAP.md {item})")
    for flag in ("k", "steps", "batch", "microbatches"):
        if getattr(args, flag) < 1:
            raise SystemExit(f"--{flag} must be >= 1, got {getattr(args, flag)}")
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
    peft = get_peft(PeftConfig(method=args.peft, k=args.k, strategy=args.strategy))
    tcfg = TrainConfig(learning_rate=args.lr, steps=args.steps, seed=args.seed,
                       microbatches=args.microbatches, remat=args.remat)
    trainer = Trainer(model, peft, tcfg, params)
    st = stats(params, trainer.state.trainable)
    log.info("arch=%s peft=%s trainable=%s/%s (%.4f%%) device=%s", cfg.name, args.peft,
             f"{st['trainable']:,}", f"{st['total']:,}", 100 * st["fraction"], device)
    data = DataLoader(args.task, cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    try:
        hist = trainer.run(data, steps=args.steps)
    finally:
        data.close()
    log.info("done: trainable=%s (%.4f%%) loss %.4f -> %.4f; stragglers=%d skipped=%d",
             f"{st['trainable']:,}", 100 * st["fraction"], hist[0]["loss"], hist[-1]["loss"],
             len(trainer.monitor.flagged), trainer.nan_guard.skipped)
    if args.export_adapter:
        # neuroada: aux is the indices tree, trainable the values tree
        export_adapter(args.export_adapter, trainer.aux, trainer.state.trainable,
                       {"arch": cfg.name, "peft": args.peft})
        log.info("unmerged adapter exported to %s", args.export_adapter)
    return hist


if __name__ == "__main__":
    main()
