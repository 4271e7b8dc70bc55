"""NeuroAda vs LoRA vs BitFit vs mask-based vs full FT on the same task,
same protocol (the paper's Tables 2–4 comparison at a small scale), on the
port (twin of the reference's ``examples/peft_comparison.py``).

  PYTHONPATH=src python -m repro_torch.examples.peft_comparison [--steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.examples.common import bench_model, train_and_eval

ROWS = (
    ("neuroada", dict(k=1, lr=3e-3)),
    ("neuroada", dict(k=16, lr=3e-3)),
    ("lora", dict(lora_rank=4, lr=1e-3)),
    ("bitfit", dict(lr=1e-3)),
    ("masked", dict(k=16, lr=3e-3)),
    ("full", dict(lr=5e-4)),
)


def run(cfg, m, params, *, steps: int = 150, device=None) -> list:
    """The table: one ``train_and_eval`` row a method, printed as it comes;
    returns the rows (each with its ``tag``)."""
    print(f"{'method':10s} {'trainable%':>10s} {'acc':>6s} {'loss':>7s} "
          f"{'opt state':>10s} {'samp/s':>7s}")
    rows = []
    for method, kw in ROWS:
        r = train_and_eval(cfg, m, params, method, steps=steps,
                           task="reasoning", device=device, **kw)
        tag = method + (f"(k={kw['k']})" if "k" in kw else "")
        print(f"{tag:10s} {r['fraction']:>9.4%} {r['acc']:>6.1%} "
              f"{r['final_loss']:>7.3f} {r['opt_state_bytes']/2**20:>8.2f}MB "
              f"{r['samples_per_s']:>7.1f}")
        rows.append(dict(r, tag=tag))
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, m, params = bench_model("qwen2-1.5b", device=dev)
    return run(cfg, m, params, steps=args.steps, device=dev)


if __name__ == "__main__":
    main()
