"""End-to-end training example on the port (twin of the reference's
``examples/finetune_e2e.py``): a ~100M-param dense LM fine-tuned with
NeuroAda for a few hundred steps through the whole training stack —
host-sharded data pipeline, gradient accumulation, NaN guard, straggler
monitor, asynchronous checkpoints with kill-and-resume.

  PYTHONPATH=src python -m repro_torch.examples.finetune_e2e [--steps 300] \\
      [--arch qwen2-1.5b] [--ckpt DIR] [--resume] [--device cpu]

Without ``--resume`` the ``--ckpt`` directory is deleted first. Its
default, ``repro_torch_e2e_ckpt`` in the temporary directory
(``$TMPDIR``, else ``/tmp``), is not the reference example's, so running
one package's example never deletes the other's checkpoints.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import tempfile

from repro_torch.configs import PeftConfig, TrainConfig, get_config
from repro_torch.data import DataLoader
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.peft import get_peft, stats
from repro_torch.train import Trainer

DEFAULT_CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_e2e_ckpt")
CHECKPOINT_EVERY = 100


def build_100m(arch: str):
    """~90M params: real depth and width (the reference's config, field for
    field)."""
    cfg = get_config(arch).replace(
        name=arch + "-100m", num_layers=6, d_model=768, d_ff=2048,
        num_heads=12, num_kv_heads=4, head_dim=64, vocab_size=32000,
        flash_threshold=1 << 30,
    )
    return cfg


def run(cfg, params, *, steps: int = 300, ckpt: str = DEFAULT_CKPT, k: int = 1,
        resume: bool = False, device=None) -> dict:
    """Train ``steps`` steps (from the latest checkpoint in ``ckpt`` with
    ``resume``, else from scratch after deleting ``ckpt``); ``params`` are
    ``cfg``'s, on ``device``. Returns every number printed, the losses by
    step and the straggler monitor's moving mean of the step time."""
    resolve_device(device)
    if not resume and os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    model = get_model(cfg)
    peft = get_peft(PeftConfig(method="neuroada", k=k))
    tcfg = TrainConfig(
        learning_rate=3e-3, steps=steps, microbatches=2,
        checkpoint_every=CHECKPOINT_EVERY, checkpoint_dir=ckpt, log_every=20,
    )
    trainer = Trainer(model, peft, tcfg, params)
    st = stats(params, trainer.state.trainable)
    print(f"model ≈{st['total']/1e6:.0f}M params; trainable {st['fraction']:.4%}")

    start = trainer.try_resume()
    data = DataLoader(
        "arithmetic", cfg.vocab_size, 32, 64, seed=1, start_step=start,
        host_id=0, host_count=1,
    )
    try:
        hist = trainer.run(data, steps=steps)
    finally:
        data.close()
    out = {"total": st["total"], "fraction": st["fraction"], "start": start,
           "losses": {h["step"]: h["loss"] for h in hist},
           "stragglers": len(trainer.monitor.flagged), "skipped": trainer.nan_guard.skipped,
           "step_ms_ewma": trainer.monitor.mean * 1e3,
           "checkpoints": trainer.ckpt.steps()}
    final = hist[-1]["loss"] if hist else float("nan")
    print(f"final loss {final:.4f}; "
          f"stragglers flagged: {out['stragglers']}; "
          f"skipped (NaN-guard): {out['skipped']}")
    print(f"checkpoints: {out['checkpoints']} in {ckpt}")
    print("re-run with --resume to continue from the latest checkpoint")
    return out


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--ckpt", default=DEFAULT_CKPT)
    ap.add_argument("--k", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_100m(args.arch)
    params = get_model(cfg).init(seed=0, device=dev)
    return run(cfg, params, steps=args.steps, ckpt=args.ckpt, k=args.k,
               resume=args.resume, device=dev)


if __name__ == "__main__":
    main()
