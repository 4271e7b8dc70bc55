"""The serve launcher's ``--tp`` and the engine's tensor-parallel refusals,
on the CPU.

Refused in the reference's words: ``--tp 0`` (``validate_args`` of both
launchers on one parsed namespace); a ``--tp`` that does not divide the
local GPUs (the port's launcher on a stand-in one-GPU machine against the
reference's on its one CPU device, both ``SystemExit``); heads that do not
divide (the reference's launcher reaching its check through a stand-in
mesh); and, in the engines, ``num_kv_heads`` that does not divide (a
stand-in group against the reference's stand-in mesh). Families other than
the dense one are refused at tp > 1. ``--device cpu --tp 2 --reduced``
answers its prompts with ``--tp 1``'s tokens, and ``--serve --tp 2``
answers a request, drains on ``/admin/shutdown`` and ends with every
process (the followers report to the leader, which exits 0).
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch import mesh as j_mesh
from repro.launch import serve as j_launch
from repro.models import get_model as j_get_model
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import serve as launch
from repro_torch.models import get_model
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--reduced", "--device", "cpu"]
PROMPTS = "1,17,25;1,40,41,42;3,5"


def refusal(fn, *args, exc=SystemExit, **kw) -> str:
    with pytest.raises(exc) as ei:
        fn(*args, **kw)
    return str(ei.value)


def test_tp_below_one_refused_as_the_reference():
    args = launch.build_parser().parse_args(["--device", "cpu", "--tp", "0"])
    want = refusal(j_launch.validate_args, args)
    assert refusal(launch.validate_args, args) == want == "--tp must be >= 1, got 0"


@pytest.mark.parametrize("tp", [2, 7])
def test_tp_that_does_not_divide_the_devices_refused_as_the_reference(tp, monkeypatch):
    want = refusal(j_launch.main, ["--reduced", "--tp", str(tp)])  # one CPU device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # a one-GPU machine
    got = refusal(launch.main, ["--reduced", "--tp", str(tp)])
    assert got == want == f"--tp {tp}: tp={tp} does not divide the 1 local devices"


class StandInMesh:
    axis_names = ("model",)

    def __init__(self, tp):
        self.shape = {"model": tp}


class StandInGroup:
    def __init__(self, tp):
        self.tp, self.rank, self.leader = tp, 0, True


def test_heads_that_do_not_divide_refused_as_the_reference(monkeypatch):
    monkeypatch.setattr(j_mesh, "make_serve_mesh", lambda tp: StandInMesh(tp))
    want = refusal(j_launch.main, ["--reduced", "--tp", "3"])
    got = refusal(launch.main, [*BASE, "--tp", "3"])
    assert got == want == "--tp 3 does not divide num_kv_heads=2 for --arch qwen2-1.5b"


def test_engine_refuses_heads_and_families_before_placement():
    cfg = reduced(get_config("qwen2-1.5b")).replace(dtype="float32")
    jm = j_get_model(cfg)
    want = refusal(JEngine, jm, jm.init(jax.random.PRNGKey(0)), mesh=StandInMesh(3),
                   exc=ValueError)
    tm = get_model(t_reduced(t_get_config("qwen2-1.5b")).replace(dtype="float32"))
    got = refusal(ServeEngine, tm, None, device="cpu", tp_group=StandInGroup(3),
                  exc=ValueError)  # no params: the check comes before any placement
    assert got == want and "num_kv_heads=2" in got
    moe = get_model(t_reduced(t_get_config("olmoe-1b-7b")))
    got = refusal(ServeEngine, moe, None, device="cpu", tp_group=StandInGroup(2),
                  exc=ValueError)
    assert "covers the dense family" in got and "'moe'" in got


def token_lines(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if ln.startswith("req")]


def test_device_cpu_tp2_answers_with_tp1_tokens(capsys):
    argv = [*BASE, "--prompts", PROMPTS, "--max-new", "6"]
    launch.main(argv)
    want = token_lines(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv, "--tp", "2"],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "serving tensor-parallel over 2 shards (gloo" in proc.stdout
    assert token_lines(proc.stdout) == want and len(want) == 3
    assert "tp=2 pool_bytes_per_shard=" in proc.stdout


def test_serve_mode_tp2_answers_drains_and_ends_every_rank():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *BASE, "--tp", "2", "--serve",
           "--port", "0"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        line = ""
        while "serving on" not in line:
            line = proc.stdout.readline()
            assert line, "the launcher exited before serving"
        url = line.split()[2]
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

        def post(path, body):
            req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                         method="POST")
            with opener.open(req, timeout=120) as r:
                return r.status, r.read()

        st, body = post("/v1/generate", {"prompt": [1, 17, 25], "max_new": 5, "stream": False})
        out = json.loads(body)
        assert st == 200 and len(out["tokens"]) == 5
        st, _ = post("/admin/shutdown", {})
        assert st == 200
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "server drained" in rest, (proc.returncode, rest)
