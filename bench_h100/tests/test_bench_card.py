"""The command itself: without a card it exits non-zero and prints no
result; on the card (marked `cuda`, skipped elsewhere) a short run of a
cell prints a result line that the contract's readers can read."""

import json
import subprocess
import sys

import pytest

from bench_h100.harness import BENCH, ROOT


def run(*args, timeout=600):
    return subprocess.run([sys.executable, str(BENCH / "run.py"), *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run("--workload", "r50.infer", "--seed", str(2**31 + 1), "--seconds", "1")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_short_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = run("--workload", "r50.infer", "--seed", str(2**31 + 7), "--seconds", "3",
              "--trace", trace)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "compared"
    assert ("busy_s" in res["device"]) == (trace == "1")
