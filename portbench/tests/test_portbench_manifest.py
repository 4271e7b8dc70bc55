"""BENCHMARK.json against the contract the harness is written to, and the
harness's discovery of every file it names."""

import json
import re

import pytest

from portbench.harness import manifest

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_shape_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and c["source"].startswith("https://")


def test_every_cell_reports_what_its_metrics_move():
    for w in CELLS:
        cell = manifest.cell(w, BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w, m["name"])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_declare_their_entry(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    mod = manifest.reader(name)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.BETTER) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"], entry["better"])
    assert callable(mod.read)


@pytest.mark.parametrize("workload", CELLS)
def test_cells_find_their_files(workload):
    from portbench.harness import judge

    cell = manifest.cell(workload, BENCH)
    assert cell.mix["kind"] == "train"
    assert cell.arch.name == next(w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    lim = judge.limits_of(workload)
    assert set(lim) == {"selection_mismatch", "loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configs_state_what_the_program_computes(name, tmp_path):
    from portbench.harness import arch as arch_lib

    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    a = arch_lib.load(manifest.ROOT / entry["file"])
    assert (a.family, a.qkv_bias, a.qk_norm) == (cfg["family"], cfg["qkv_bias"], cfg["qk_norm"])
    assert cfg["source"] == entry["source"] and entry["reduced"] == []
    broken = tmp_path / f"{name}.json"
    broken.write_text(json.dumps({k: v for k, v in cfg.items() if k != "qk_norm"}))
    with pytest.raises(KeyError, match="qk_norm"):
        arch_lib.load(broken)
