"""A whole run of each cell on the card, as the benchmark's command runs it,
with a short window: it exits 0 and its last line says correct. Marked
``cuda``; without a card it skips (decided inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["orbit512_dog.batch", "orbit512_dog.stream"])
def test_a_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark runs on the card only")
    p = subprocess.run([sys.executable, "sfmbench/run.py", "--workload", workload,
                        "--seed", "987654321", "--seconds", "5", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True, p.stderr[-2000:]


def test_without_a_card_it_exits_non_zero_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "sfmbench/run.py", "--workload", "orbit512_dog.batch",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
