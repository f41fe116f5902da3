"""A run needs the card: without one it exits non-zero and prints no
result; with one (``requires_cuda``) a short run of a cell is correct."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import core


def run_cell(seconds: str):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "scannet-semseg-test",
         "--seed", "2147483659", "--seconds", seconds, "--trace", "0"],
        cwd=core.ROOT, capture_output=True, text=True, timeout=1500)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = run_cell("1")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.requires_cuda
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run_cell("20")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
