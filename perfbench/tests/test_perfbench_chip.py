"""One short cell on the card, as the benchmark runs it (a new process
from the checkout's root): the result line is correct and names the
card.  Skips without a card (decided inside the test)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
def test_one_short_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "pems-steady",
         "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    assert {"windows_per_s", "setup_s"} <= set(out["metrics"])


def test_no_card_no_result(tmp_path, monkeypatch):
    """Without a card the run exits non-zero and prints no result."""
    import torch
    from perfbench import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--workload", "pems-steady", "--seed", "1",
                       "--seconds", "1"]) != 0
