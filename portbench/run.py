"""Run one cell of the port's benchmark once and print its result line.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a model configuration
and a mix; the mix's ``kind`` picks the driver (``train``, the only one so
far). The weights and batches come from ``--seed``. With ``--trace 0`` the
line carries the cell's end-to-end metrics; with ``--trace 1`` the device
is traced over the window and the line carries its per-layer metrics,
``busy_s`` / ``window_s`` and a breakdown. Either way the window's outputs
are compared with the plain reference afterwards, and every number
compared is printed beside its limit, last on standard error and last in
the line. Without CUDA, or with fewer devices than the cell asks for, it
exits with 3 and prints no result; if JAX or the JAX package is loaded by
the time the window has closed, with 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``repro_torch`` is the program, not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run ``cell`` once on ``device``; returns the result line's object."""
    from portbench.harness import devtrace, judge, trainrun
    from portbench.harness.manifest import reader

    driver = {"train": trainrun}[cell.mix["kind"]]
    tr = devtrace.DeviceTrace() if trace else None
    rec = driver.run(cell.arch, cell.mix, seed, seconds, tr, t_start, device)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": rec.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": cell.chips,
           "memory_peak_bytes": rec.peak_bytes}
    out = {"correct": False, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": dev}
    if trace:
        ops = rec.ops()
        dev["busy_s"] = devtrace.busy_seconds(ops)
        dev["window_s"] = rec.window_s
        out["breakdown"] = {"device_ops": devtrace.by_name(ops),
                            "idle_gaps": devtrace.idle_gaps(ops, tr.spans, *rec.window)}
    numbers = judge.train_numbers(rec.program, judge.train_reference(rec))
    out["correct"], out["checks"] = judge.judge(numbers, judge.limits_of(cell.name))
    return out


def _device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness.manifest import cell as find_cell

    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                  T_START)
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: the run loaded {leaked}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
