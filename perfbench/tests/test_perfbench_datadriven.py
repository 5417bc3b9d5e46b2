"""A later change adds a configuration, a reference, a traffic mix, an
arrival process and a metric by adding files and entries only: in a copy
of the benchmark, new files are found by the names in BENCHMARK.json and
in the new configuration and mix, and a run reports the new metric and
is judged by the reference its configuration names, with no file of the
copy edited but BENCHMARK.json."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from perfbench.bench import Spec, run_cell

ROOT = Path(__file__).resolve().parents[2]

EVEN = '''"""``even``: one arrival every ``1 / rate_per_s`` seconds."""

import numpy as np

from perfbench.traffic import cycle

PARAMS = ("rate_per_s",)


def schedule(mix, seed, seconds):
    gap = 1.0 / float(mix.params["rate_per_s"])
    return cycle(np.arange(gap, seconds, gap), seed, mix.streams)
'''

OFF_BY_ONE = '''"""A reference that is one code off on every window."""

from perfbench.reference import qlstm


def predict(cfg, params, stream, k, x, device="cpu", lower=False):
    codes, frac = qlstm.predict(cfg, params, stream, k, x, device, lower)
    return codes + 1, frac
'''


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add(root: Path, rel: str, text: str) -> None:
    path = root / "perfbench" / rel
    assert not path.exists()
    path.write_text(text)


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    cfg = json.loads((tmp_path / "perfbench/configs/lstm-pems.json")
                     .read_text())
    cfg["weights"]["scale"] = 2.0
    _add(tmp_path, "configs/lstm-dummy.json", json.dumps(cfg))
    _add(tmp_path, "configs/lstm-wrong.json",
         json.dumps({**cfg, "reference": "off_by_one"}))
    _add(tmp_path, "reference/off_by_one.py", OFF_BY_ONE)
    _add(tmp_path, "arrivals/even.py", EVEN)
    _add(tmp_path, "traffic/dummy-mix.json", json.dumps(
        {"arrivals": "even", "streams": 20, "rate_per_s": 300, "batch": 8,
         "deadline_s": 0.004}))
    _add(tmp_path, "metrics/dummy_windows.py",
         '"""Windows sent in the measured window."""\n\n\n'
         "def read(run):\n"
         "    return float(run.due_in_window().sum())\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name in ("lstm-dummy", "lstm-wrong"):
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    bench["workloads"] += [
        {"name": "dummy-cell", "config": "lstm-dummy", "traffic": "dummy-mix",
         "chips": 1, "why": "test"},
        {"name": "wrong-cell", "config": "lstm-wrong", "traffic": "dummy-mix",
         "chips": 1, "why": "test"}]
    bench["per_layer"].append({"name": "dummy_windows.sent", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "load generator",
                               "moves": "window_p90_ms",
                               "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    yield tmp_path
    after = _digests(tmp_path)
    assert all(after[p] == d for p, d in before.items())


def test_new_files_are_found_by_name(copy):
    spec = Spec(copy)
    assert spec.config("lstm-dummy")["weights"]["scale"] == 2.0
    mix = spec.mix(spec.workload("dummy-cell")["traffic"])
    assert mix.streams == 20 and mix.arrivals == "even"
    sched = spec.module("arrivals", mix.arrivals).schedule(mix, 1, 1.0)
    assert len(sched.due) == 299
    names = [m["name"] for m in spec.metrics("dummy-cell", True)]
    assert "dummy_windows.sent" in names
    assert "gen_late_ms" not in names            # lists other cells only
    assert hasattr(spec.reader("dummy_windows.sent"), "read")
    assert spec.reader("wave_ms.tail").__doc__.startswith("``wave_ms``")
    with pytest.raises(KeyError, match="no reference module"):
        spec.module("reference", "nothing_here")


def test_a_run_uses_the_new_files(copy):
    out = run_cell("dummy-cell", 11, 1.0, True, device="cpu", root=copy)[0]
    assert out["correct"], out["checks"]
    assert out["metrics"]["dummy_windows.sent"]["value"] > 200


def test_a_run_is_judged_by_the_reference_its_config_names(copy):
    out = run_cell("wrong-cell", 11, 1.0, False, device="cpu", root=copy)[0]
    assert not out["correct"]
    assert out["checks"]["mismatched"]["value"] == out["attempted"]
    assert out["checks"]["max_code_gap"]["value"] == 1.0
