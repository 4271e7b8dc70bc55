"""Tensor-parallel serving of the MoE family, continued: the speculative
drafters at tp 2 and 4 against the reference's tp = 1 engine — the int8
self-drafter on the paged pool (its packed base, built before the split,
is cut like the served one: each rank drafts on its own experts with its
own dense scratch) and ngram on the dense cache — and the launcher:
``--tp 2 --arch olmoe-1b-7b --reduced --device cpu`` prints ``--tp 1``'s
tokens and how many experts each shard holds. World, settings and helpers
are ``test_torch_tp_moe_serve.py``'s.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import serve as launch
from test_torch_tp_moe_serve import MOE, MOE_CASES
from test_torch_tp_serve import Grid

ROOT = Path(__file__).resolve().parents[1]
FILE_CASES = ("paged_spec_int8", "dense_ngram")


@pytest.fixture(scope="module")
def grid():
    return Grid(FILE_CASES, MOE_CASES)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", FILE_CASES)
def test_moe_tp_tokens_match_reference_tp1(grid, name, tp):
    grid.check(name, tp)


def test_launcher_tp2_moe_answers_with_tp1_tokens(capsys):
    argv = ["--arch", MOE, "--reduced", "--device", "cpu", "--prompts",
            "1,17,25;1,40,41,42;3,5", "--max-new", "6"]
    launch.main(argv)
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("req")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *argv, "--tp", "2"],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = [ln for ln in proc.stdout.splitlines() if ln.startswith("req")]
    assert got == want and len(want) == 3
    assert "expert parallel: 2 of 4 experts a shard" in proc.stdout
    assert "tp=2 pool_bytes_per_shard=" in proc.stdout
