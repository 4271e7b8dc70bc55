"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration file, its mix (``portbench/mixes/<traffic>.json``), its
limits (``portbench/limits/<workload>.json``) and the reader of each of its
per-layer metrics (``portbench/metrics/<name>.py``). A later cell, mix or
metric is a new file and a new entry; nothing here changes for it."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

from . import arch as arch_lib

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    arch: arch_lib.Arch
    mix: dict
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _in(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def mix_of(traffic: str) -> dict:
    return json.loads((BENCH / "mixes" / f"{traffic}.json").read_text())


def cell(workload: str, bench: dict | None = None) -> Cell:
    bench = load() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(w["name"], w["chips"], arch_lib.load(ROOT / cfg["file"]), mix_of(w["traffic"]),
                [m for m in bench["end_to_end"] if _in(m, workload)],
                [m for m in bench["per_layer"] if _in(m, workload)])


def reader(name: str):
    """The module ``portbench/metrics/<name>.py`` (its ``read(rec)``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
