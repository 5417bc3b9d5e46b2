"""A later change adds a configuration, a reference, a traffic mix, an
arrival process and a metric by adding files and entries only: in a copy
of the benchmark, new files are found by the names in BENCHMARK.json and
in the new configuration and mix, and a run reports the new metric and
is judged by the reference its configuration names, with no file of the
copy edited but BENCHMARK.json.  That holds for a system that is not the
quantised LSTM (``second_system/``): its own server, requests of token
ids of varying length, answers three floats wide, counters, a mix key
its requests read, and a reference with its own tolerance."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench.bench import Spec, run_cell
from perfbench.control import readings

ROOT = Path(__file__).resolve().parents[2]
SECOND = Path(__file__).resolve().parent / "second_system"
SEED = 2 ** 31 + 271

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


SHIFTED = '''"""``rnn_float`` with every answer moved by twice its tolerance."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "rnn_float_base", Path(__file__).with_name("rnn_float.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)
LIMITS, readings, answers = base.LIMITS, base.readings, base.answers


def predict(cfg, params, stream, k, x, device="cpu", lower=False):
    (want,) = base.predict(cfg, params, stream, k, x, device, lower)
    return (want + 2 * LIMITS["max_abs_gap"],)
'''

RNN = {"system": "rnn_sessions", "reference": "rnn_float",
       "model": {"vocab": 64, "state": 16, "out": 3}}
TURNS = {"arrivals": "poisson", "streams": 12, "rate_per_s": 300,
         "batch": 4, "deadline_s": 0.002, "max_tokens": 9}


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
    _add(tmp_path, "systems/rnn_sessions.py",
         (SECOND / "rnn_sessions.py").read_text())
    _add(tmp_path, "reference/rnn_float.py",
         (SECOND / "rnn_float.py").read_text())
    _add(tmp_path, "reference/rnn_float_shifted.py", SHIFTED)
    _add(tmp_path, "configs/rnn-small.json", json.dumps(RNN))
    _add(tmp_path, "configs/rnn-shifted.json",
         json.dumps({**RNN, "reference": "rnn_float_shifted"}))
    _add(tmp_path, "traffic/turns.json", json.dumps(TURNS))
    _add(tmp_path, "traffic/turns-unread.json",
         json.dumps({**TURNS, "burst": 2}))
    _add(tmp_path, "traffic/turns-short.json",
         json.dumps({k: v for k, v in TURNS.items() if k != "max_tokens"}))
    _add(tmp_path, "metrics/dummy_windows.py",
         '"""Windows sent in the measured window."""\n\n\n'
         "def read(run):\n"
         "    return float(run.due_in_window().sum())\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name in ("lstm-dummy", "lstm-wrong", "rnn-small", "rnn-shifted"):
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"perfbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    bench["workloads"] += [
        {"name": "dummy-cell", "config": "lstm-dummy", "traffic": "dummy-mix",
         "chips": 1, "why": "test"},
        {"name": "wrong-cell", "config": "lstm-wrong", "traffic": "dummy-mix",
         "chips": 1, "why": "test"}]
    bench["workloads"] += [
        {"name": name, "config": config, "traffic": traffic, "chips": 1,
         "why": "test"}
        for name, config, traffic in [
            ("rnn-cell", "rnn-small", "turns"),
            ("rnn-shifted-cell", "rnn-shifted", "turns"),
            ("rnn-unread-cell", "rnn-small", "turns-unread"),
            ("rnn-short-cell", "rnn-small", "turns-short")]]
    bench["end_to_end"].append({"name": "window_p90_ms", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["rnn-cell",
                                              "rnn-shifted-cell"]})
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


def test_a_second_system_runs_a_cell_judged_by_its_own_reference(copy):
    out, run = run_cell("rnn-cell", SEED, 1.0, False, device="cpu",
                        root=copy)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"window_p90_ms", "setup_s"}
    assert out["attempted"] > 200 and out["failed"] == 0
    assert out["checks"] == {
        "unanswered": {"value": 0, "limit": 0},
        "max_abs_gap": {"value": out["checks"]["max_abs_gap"]["value"],
                        "limit": 1e-4}}
    assert 0 < out["checks"]["max_abs_gap"]["value"] < 1e-6   # float32
    # The system's own counters, read as the window closed.
    assert 0.9 * out["attempted"] < run.counters["requests"] \
        <= out["attempted"]
    assert run.counters["calls"] < run.counters["requests"]   # batched
    assert run.dims is None and run.bits is None
    turns = Spec(copy).module("systems", "rnn_sessions").payload(
        RNN, run.mix, SEED).take(run.stream, run.k)
    assert {len(t) for t in turns} == set(range(1, 10))


def test_a_second_system_against_a_shifted_reference_is_not_correct(copy):
    out = run_cell("rnn-shifted-cell", SEED, 1.0, False, device="cpu",
                   root=copy)[0]
    assert not out["correct"]
    gap = out["checks"]["max_abs_gap"]
    assert gap["limit"] < gap["value"] < 3 * gap["limit"]


def test_a_second_system_is_traced_with_no_spans_of_its_own(copy):
    out = run_cell("rnn-cell", SEED + 1, 1.0, True, device="cpu",
                   root=copy)[0]
    assert out["correct"], out["checks"]
    gaps = {name for name, _ in out["breakdown"]["idle_gaps"]}
    assert gaps <= {"client.submit", "client.poll", "waiting"}


@pytest.mark.parametrize("cell,names", [
    ("rnn-unread-cell", "['burst', 'max_tokens', 'rate_per_s']"),
    ("rnn-short-cell", "['rate_per_s']")])
def test_a_mix_must_give_exactly_what_arrivals_and_requests_read(copy, cell,
                                                                  names):
    with pytest.raises(ValueError, match=r"requests read \['max_tokens'\], "
                       rf"the mix gives {re.escape(names)}"):
        run_cell(cell, SEED, 1.0, False, device="cpu", root=copy)


def test_the_control_of_a_second_system_is_not_correct(copy):
    got = readings("rnn-cell", SEED, 0.5, root=copy)
    assert got["windows"] > 100 and got["unanswered"] == 0
    assert got["max_abs_gap"] > 1e-4
