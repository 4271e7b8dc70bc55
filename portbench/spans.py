"""Where a training cell's step goes, by the program's own regions: one
traced run of the cell's window (as ``run.py --trace 1`` makes it, without
the judge), reduced to one JSON line.

  python3 portbench/spans.py --workload <name> --seed <n> --seconds <s>

The line holds, a step (medians over the window's steps): the host and
device ms of ``train.step`` and of each of its regions, and the step's
self time (what its children leave uncovered); the idle device
ms by the innermost program region the host was in at each gap's middle
(``outside`` between steps); the ten longest gaps so named; and how the
regions' device intervals agree with the CUPTI operations' clock: the
share of the busy time inside some ``train.step`` interval, inside the
forward, backward and optimizer intervals, and the median ``train.step``
device interval against the host's ``Trainer.step``. Needs CUDA (exit 3
without it) and a program that records regions (exit 5 without them).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("train.upload", "train.forward", "train.backward", "train.optimizer", "train.read",
          "moe.dispatch", "moe.combine")


def report(rec, spans) -> dict:
    """The line's object for a traced run's record ``rec`` and the
    harness's own spans (None without program regions)."""
    from portbench.harness import devtrace, progspans

    regs = progspans.regions(rec)
    if regs is None:
        return None
    tracer = progspans.program_tracer()
    inside = {id(r) for r in regs}
    roots = [i for i, r in enumerate(tracer.regions)
             if r.name == "train.step" and id(r) in inside]
    ops, (lo, hi) = rec.ops(), rec.window
    steps = [r for r in regs if r.name == "train.step"]
    n = len(steps)
    names = ("train.step",) + PHASES
    idle = progspans.idle_by_region(ops, regs, lo, hi)
    main3 = [(r.d0, r.d1) for r in regs
             if r.name in ("train.forward", "train.backward", "train.optimizer")]
    step_dev = statistics.median((r.d1 - r.d0) for r in steps) * 1e3
    p50 = statistics.median(rec.step_s) * 1e3
    return {
        "steps": n, "window_s": rec.window_s,
        "busy_s": devtrace.busy_seconds(ops),
        "train_step_p50_ms": p50,
        "host_ms": {k: progspans.per_step_ms(regs, k, device=False) for k in names},
        "device_ms": {k: progspans.per_step_ms(regs, k) for k in names},
        "idle_ms_per_step": {k: v * 1e3 / n for k, v in sorted(idle.items(),
                                                                key=lambda kv: -kv[1])},
        "idle_gaps": progspans.idle_gaps(ops, spans, regs, lo, hi),
        "busy_in_step": progspans.covered_share(ops, [(r.d0, r.d1) for r in steps]),
        "busy_in_fwd_bwd_opt": progspans.covered_share(ops, main3),
        "step_self_ms": {k: statistics.median(tracer.self_seconds(i, k == "device")
                                              for i in roots) * 1e3
                         for k in ("host", "device")},
        "step_device_p50_ms": step_dev,
        "step_device_vs_host": step_dev / p50 - 1.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import devtrace, trainrun
    from portbench.harness.manifest import cell as find_cell

    cell = find_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: needs CUDA", file=sys.stderr)
        return 3
    tr = devtrace.DeviceTrace()
    rec = trainrun.run(cell.arch, cell.mix, args.seed, args.seconds, tr, T_START,
                       torch.device("cuda"))
    out = report(rec, tr.spans)
    if out is None:
        print("portbench.spans: the program recorded no regions", file=sys.stderr)
        return 5
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
