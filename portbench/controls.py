"""The readings the limits of ``correct`` are set from, on the chip, at a
cell's own size: the control (the reference, in the program's place,
computed in float8 e4m3 — the precision below the configurations' bf16)
and the planted faults, each judged by the cell's own numbers.

  python3 portbench/controls.py --workload <name> --seeds 1,2,3

Training cells: the reference's first steps in float32 against the same
steps of the control, and of the reference with half of each batch's rows
left out (the mean over the rest). A step that returns its state
unchanged reads 1 on ``change_gap`` by construction and is not run.

The benchmark's own runs never run this. It prints one JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.harness import judge, manifest, traffic, weights
    from portbench.harness.run_record import RunRecord

    if not torch.cuda.is_available():
        print("controls: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    cell = manifest.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = {"workload": cell.name, "seed": seed}
        mix = cell.mix
        rec = RunRecord("train", cell.arch, mix, seed, (0, 0), 0, 0, 0)
        rec.inputs = {"params": weights.make_params(cell.arch, seed, dev),
                      "batches": traffic.train_batches(mix, cell.arch.vocab, seed,
                                                       mix["checked_steps"])}
        want = judge.train_reference(rec)
        for name, kw in (("control", {"precision": "fp8"}),
                         ("half_batch", {"half_batch": True})):
            out[name] = judge.train_numbers(judge.train_reference(rec, **kw), want)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
