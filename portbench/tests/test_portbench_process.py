"""The run as a process: without CUDA it fails and never falls back to the
CPU, and nothing the harness or the program loads is JAX or the JAX
package (top-level names compared whole: ``repro_torch`` is allowed)."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

IMPORTS = """
import json, pkgutil, sys, importlib
sys.path[:0] = [{root!r}, {src!r}]
import portbench.harness, portbench.reference
for pkg in (portbench.harness, portbench.reference):
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(pkg.__name__ + "." + m.name)
from portbench.harness import manifest
for m in manifest.load()["per_layer"]:
    manifest.reader(m["name"])
import repro_torch.configs.base, repro_torch.models, repro_torch.peft, repro_torch.train
sys.argv = ["run.py"]
import runpy
ns = runpy.run_path({run!r}, run_name="portbench_run")
print(json.dumps(ns["forbidden_modules"]()))
"""


def test_nothing_loads_jax_or_the_jax_package():
    code = IMPORTS.format(root=str(ROOT), src=str(ROOT / "src"),
                          run=str(ROOT / "portbench" / "run.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_run_without_cuda_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "qwen2-1.5b.train.b16s512", "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, env=env,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "CUDA" in out.stderr
