"""The port's examples (``examples/torch/*.py``) run end to end on the CPU
(``--device cpu``) in a subprocess, at small step counts, and print what
their references print: the quickstart's engines bit-identical, the
training run's test MSEs, the serving runs' rates."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")

CASES = {
    "quickstart": (["--steps", "20"], ["bit-identical = True"] * 3 + ["test MSE"]),
    "train_lstm_pems": (["--steps", "20"], ["test MSE [int8-kernel ]"]),
    "serve_lstm_realtime": (["--steps", "20", "--waves", "2"],
                            ["[serve]", "[stream] 128 windows"]),
    "explore_design_space": (["--iters", "1"], ["[autotune] deployed point"]),
    "serve_lm": (["--gen", "4", "--quant", "w8a8", "--kv-int8"],
                 ["[serve] weights quantised: mode=w8a8", "tok/s"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, expect = CASES[name]
    if name == "train_lstm_pems":
        args = args + ["--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch", f"{name}.py"),
         "--device", "cpu", *args], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    for text in expect:
        assert out.stdout.count(text) >= expect.count(text), (text, out.stdout[-2000:])
    assert "bit-identical = False" not in out.stdout
