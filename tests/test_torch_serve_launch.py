"""The port's serve launcher: the observability and front-end flags
(``--metrics-out``, ``--trace-out``, ``--metrics-every``, ``--profile-dir``,
``--serve``, ``--port``, ``--queue-limit``, ``--fairness``), on the CPU.

``validate_args`` refuses every bad combination the reference's launcher
refuses, with the reference's words (both are called on the same parsed
namespace). The metrics (Prometheus text and JSON snapshot), trace (JSONL
and Chrome JSON) and profile files parse and agree with the printed run;
``--serve --port 0`` answers a request over loopback and drains on
``/admin/shutdown``, then writes its dumps.
"""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from repro.launch import serve as j_launch
from repro_torch.launch import serve as launch

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--reduced", "--device", "cpu"]


def parsed(argv):
    return launch.build_parser().parse_args(["--device", "cpu", *argv])


REFUSED = [
    ["--metrics-every", "-1"], ["--port", "80"], ["--serve", "--port", "70000"],
    ["--serve", "--port", "-1"], ["--queue-limit", "0"], ["--fairness", "lifo"],
    ["--prompts", "", "--metrics-out", "m.json"], ["--prompts", "", "--trace-out", "t.json"],
    ["--prompts", "", "--profile-dir", "p"], ["--prompts", "1,2;,"],
    ["--metrics-out", "/no/such/dir/m.json"], ["--trace-out", "/no/such/dir/t.json"],
    ["--profile-dir", "/no/such/dir/p"], ["--decode-chunk", "0"], ["--prefill-chunk", "0"],
    ["--max-new", "0"], ["--draft", "fp8"], ["--spec-k", "0"], ["--draft", "merged"],
    ["--dense", "--paged"], ["--dense", "--page-size", "8"], ["--dense", "--num-blocks", "9"],
    ["--page-size", "12"], ["--max-len", "128", "--num-blocks", "3"],
]


@pytest.mark.parametrize("argv", REFUSED, ids=[" ".join(a) or "empty" for a in REFUSED])
def test_refusals_equal_the_reference(argv):
    args = parsed(argv)
    msgs = []
    for validate in (j_launch.validate_args, launch.validate_args):
        with pytest.raises(SystemExit) as ei:
            validate(args)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_kv_dtype_refused_as_the_reference():
    args = parsed([])
    args.kv_dtype = "fp8"  # the port's parser refuses it first
    msgs = []
    for validate in (j_launch.validate_args, launch.validate_args):
        with pytest.raises(SystemExit) as ei:
            validate(args)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("argv", [["--serve", "--prompts", ""], ["--serve", "--port", "0"],
                                  ["--fairness", "drr", "--queue-limit", "2"],
                                  ["--metrics-every", "3", "--metrics-out", "m.prom"]])
def test_accepted_by_both(argv):
    args = parsed(argv)
    j_launch.validate_args(args)
    launch.validate_args(args)


def run_main(argv, capsys) -> str:
    launch.main(BASE + argv)
    return capsys.readouterr().out


def test_metrics_trace_and_profile_files(tmp_path, capsys):
    prompts = "1,17,25;1,40,41,42;1,9"
    common = ["--prompts", prompts, "--max-new", "6", "--metrics-every", "1"]
    out = run_main(common + ["--metrics-out", str(tmp_path / "m.json"), "--trace-out",
                             str(tmp_path / "t.jsonl"), "--profile-dir",
                             str(tmp_path / "prof"), "--fairness", "drr"], capsys)
    lines = out.splitlines()
    digests = [ln for ln in lines if ln.startswith("[metrics] step=")]
    steps = int(next(ln for ln in lines if ln.startswith("steps=")).split()[0][6:])
    assert len(digests) == steps and "compiles=0" in digests[-1] and "pool=" in digests[-1]
    outs = [ln for ln in lines if ln.startswith("req")]
    n_tok = sum(len(json.loads(ln.split("-> ")[1])) for ln in outs)

    snap = json.loads((tmp_path / "m.json").read_text())
    tok = sum(s["value"] for s in snap["serve_tokens_total"]["series"])
    fin = sum(s["value"] for s in snap["serve_requests_finished_total"]["series"])
    assert tok == n_tok and fin == len(outs) == 3
    assert snap["serve_transfers_total"]["series"][0]["value"] == steps
    assert snap["serve_ttft_seconds"]["series"][0]["count"] == 3
    assert snap["serve_itl_seconds"]["series"][0]["count"] == n_tok - 3
    events = [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert sorted(e["rid"] for e in events if e["name"] == "finish") == [0, 1, 2]
    assert sum(e["name"] == "first_token" for e in events) == 3
    prof = list((tmp_path / "prof").iterdir())
    assert len(prof) == 1 and json.loads(prof[0].read_text())["traceEvents"]

    out = run_main(common + ["--metrics-out", str(tmp_path / "m.prom"), "--trace-out",
                             str(tmp_path / "t.json")], capsys)
    text = (tmp_path / "m.prom").read_text()
    assert "# TYPE serve_ttft_seconds histogram" in text
    assert 'serve_ttft_seconds_bucket{le="+Inf"} 3' in text
    chrome = json.loads((tmp_path / "t.json").read_text())
    assert {e["tid"] for e in chrome["traceEvents"]} == {0, 1, 2}


def test_metric_families_are_the_references(tmp_path, capsys):
    """The same flags on both launchers dump the same metric families."""
    argv = ["--reduced", "--prompts", "1,17,25;1,40,41,42", "--max-new", "3"]
    j_launch.main(argv + ["--metrics-out", str(tmp_path / "j.json")])
    launch.main(argv + ["--device", "cpu", "--metrics-out", str(tmp_path / "p.json")])
    capsys.readouterr()
    ref = json.loads((tmp_path / "j.json").read_text())
    port = json.loads((tmp_path / "p.json").read_text())
    assert list(port) == list(ref)
    for name in ref:
        assert port[name]["type"] == ref[name]["type"] and port[name]["help"] == ref[name]["help"]
    assert port["serve_jit_compiles"]["series"][0]["value"] == 0


def test_serve_mode_answers_and_drains(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *BASE, "--serve", "--port", "0",
           "--queue-limit", "4", "--metrics-out", str(tmp_path / "m.json"),
           "--trace-out", str(tmp_path / "t.jsonl")]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        line = ""
        while "serving on" not in line:
            line = proc.stdout.readline()
            assert line, "the launcher exited before serving"
        url = line.split()[2]
        # loopback straight, whatever proxy the environment names
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

        def post(path, body):
            req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                         method="POST")
            with opener.open(req, timeout=60) as r:
                return r.status, r.read()

        st, body = post("/v1/generate", {"prompt": [1, 17, 25], "max_new": 5, "stream": False})
        out = json.loads(body)
        assert st == 200 and len(out["tokens"]) == 5 and out["reason"] in ("max_new", "eos")
        st, body = post("/v1/generate", {"prompt": [1, 9], "max_new": 3})
        frames = [json.loads(ln[6:]) for ln in body.decode().splitlines()
                  if ln.startswith("data: ")]
        assert st == 200 and frames[-1]["done"]
        with opener.open(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["ok"]
        st, _ = post("/admin/shutdown", {})
        assert st == 200
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0 and "server drained" in rest, (proc.returncode, rest)
    snap = json.loads((tmp_path / "m.json").read_text())
    assert sum(s["value"] for s in snap["serve_requests_finished_total"]["series"]) == 2
    events = [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert sum(e["name"] == "finish" for e in events) == 2
