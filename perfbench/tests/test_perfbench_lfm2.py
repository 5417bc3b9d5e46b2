"""The LFM2 cell's files (``systems/lfm2_sessions.py``,
``reference/lfm2.py``, ``configs/lfm2-8b-a1b.json``,
``traffic/sessions256-turns.json``, the three ``metrics/``) and
``pems-burst``'s (``arrivals/clock_burst.py``,
``traffic/burst8600-3200.json``) on the CPU.  The LFM2 cell runs in a
copy of the benchmark whose configuration keeps every key but is cut to
a tiny width (the full model is 16.7 GB), with the mix's sizes cut
likewise through ``mix_overrides``."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.bench import Spec, run_cell
from perfbench.control import readings

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 33 + 5
# the published first 8 layers (2 attention), at width 64: deep enough
# that the float8 control's gaps grow past the limits, as at full size
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=96, moe_intermediate_size=48, num_experts=8,
            num_hidden_layers=8, num_dense_layers=1, vocab_size=128,
            answer_ids=16, compare_sessions=4)
SMALL_MIX = {"streams": 6, "rate_per_s": 40, "batch": 3, "deadline_s": 0.01,
             "max_positions": 64, "history_min": 8, "history_max": 24,
             "turn_min": 2, "turn_max": 12}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark whose LFM2 configuration is tiny."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = root / "perfbench" / "configs" / "lfm2-8b-a1b.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY, layer_types=cfg["layer_types"][:TINY["num_hidden_layers"]])
    path.write_text(json.dumps(cfg))
    return root


def test_full_configuration_is_the_published_one():
    """Every number of the catalog's LFM2-8B-A1B config, under its key,
    and the port's model built from them counts 8.34 B parameters."""
    from repro_torch.models import transformer as T
    spec = Spec(ROOT)
    cfg = spec.config("lfm2-8b-a1b")
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_experts"],
            cfg["num_experts_per_tok"], cfg["moe_intermediate_size"],
            cfg["intermediate_size"], cfg["vocab_size"]) == \
        (2048, 24, 32, 4, 1792, 7168, 65536)
    assert [c for c in spec.bench["configs"]
            if c["name"] == "lfm2-8b-a1b"][0]["reduced"] == []
    mcfg = spec.module("systems", "lfm2_sessions").model_config(cfg)
    assert round(T.num_params(mcfg) / 1e9, 2) == 8.34
    from repro_torch.configs import ARCH_CONFIGS
    assert mcfg == ARCH_CONFIGS["lfm2-8b-a1b"].replace(notes="")


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_tiny_lfm2_cell_runs_and_is_correct(tiny_root, trace):
    """Histories prefilled, turns served through ``SessionServer`` with
    restarts, every turn answered, the sampled sessions' turns within the
    reference's limits at bf16; the traced run reads the new metrics."""
    out, run = run_cell("lfm2-chat-ttft", SEED, 2.0, trace, device="cpu",
                        root=tiny_root, mix_overrides=SMALL_MIX)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 70
    assert set(out["checks"]) == {"unanswered", "nonfinite",
                                  "rel_err_median", "rel_err_p90"}
    assert run.counters["restarts"] > 0 and run.counters["samples"] > 0
    if trace:
        got = out["metrics"]
        assert {"window_p90_ms.serve", "wave_occupancy.tail", "wave_ms.tail",
                "pending_ms.tail", "expert_imbalance.tail"} <= set(got)
        assert got["expert_imbalance.tail"]["value"] >= 1.0
        # no device operation on the CPU: nothing for the device's shares
        assert not {"mfu_bf16.tail", "device_idle.tail",
                    "moe_share.tail"} & set(got)
    else:
        assert set(out["metrics"]) == {"windows_per_s", "setup_s"}


def test_lower_precision_control_fails_the_limits(tiny_root):
    """The reference with float8-rounded weights in the program's place
    fails at least one limit; the same turns answered by the program at
    bf16 pass (the run above)."""
    ref = Spec(tiny_root).module("reference", "lfm2")
    got = readings("lfm2-chat-ttft", SEED, 2.0, device="cpu", root=tiny_root,
                   mix_overrides=SMALL_MIX)
    assert got["unanswered"] == 0 and got["nonfinite"] == 0
    assert got["rel_err_p90"] > ref.LIMITS["rel_err_p90"]


def _moe_run(ops, t_a=0.0, t_b=1.0):
    from types import SimpleNamespace
    from perfbench.trace import TraceResult
    return SimpleNamespace(trace=TraceResult(t_a, t_b, ops, []))


def test_moe_share_reads_the_device_time_between_the_marks():
    """The MoE's share is the union of the device operations between a
    begin and an end mark over the device's busy time: idle time counts
    on neither side, overlapping operations once, the marks not at all;
    a sub-window that opens inside a section counts its head."""
    from perfbench.metrics import moe_share
    B = "void at::native::vectorized_elementwise_kernel<8, " \
        "at::native::FillFunctor<short>, std::array<char*, 1ul> >"
    E = "void at::native::vectorized_elementwise_kernel<4, " \
        "at::native::FillFunctor<c10::complex<float> >, " \
        "std::array<char*, 1ul> >"
    ops = [("router_gemm", 0.00, 0.10),      # inside: the window opened in it
           (E, 0.10, 0.11),
           ("attn", 0.20, 0.30),
           (B, 0.40, 0.41),
           ("grouped_mm", 0.50, 0.60), ("scatter", 0.55, 0.70),
           (E, 0.70, 0.71),
           ("norm", 0.80, 0.90)]
    busy = 0.10 + 0.01 + 0.10 + 0.01 + 0.20 + 0.01 + 0.10
    got = moe_share.read(_moe_run(ops))
    assert got == pytest.approx(100.0 * (0.10 + 0.20) / busy)
    # clipped to the sub-window like the busy time
    got = moe_share.read(_moe_run(ops, 0.05, 0.95))
    assert got == pytest.approx(100.0 * (0.05 + 0.20) / (busy - 0.05))


@pytest.mark.parametrize("seed", range(5))
def test_moe_share_stays_within_the_busy_time(seed):
    """Whatever the operations and marks, the share lies in [0, 100]."""
    from perfbench.metrics import moe_share
    rng = np.random.default_rng(seed)
    names = ["FillFunctor<short>", "FillFunctor<c10::complex<float> >",
             "gemm", "elementwise"]
    starts = np.sort(rng.uniform(-0.2, 1.2, 200))
    kinds = rng.integers(2, 4, len(starts))
    kinds[::7] = [0, 1] * (len(kinds[::7]) // 2) + [0] * (len(kinds[::7]) % 2)
    ops = [(names[kd], s, s + rng.uniform(0, 0.05))
           for kd, s in zip(kinds, starts)]
    got = moe_share.read(_moe_run(ops))
    assert got is not None and 0.0 <= got <= 100.0 + 1e-9


def test_moe_share_is_silent_without_marks():
    """A program that marks nothing (the parent's) reads nothing."""
    from perfbench.metrics import moe_share
    assert moe_share.read(_moe_run([("gemm", 0.1, 0.2)])) is None
    assert moe_share.read(_moe_run([])) is None


@pytest.mark.parametrize("rate,period,seconds",
                         [(3200, 0.25, 51.0), (3200, 0.25, 54.5),
                          (300, 0.1, 2.0), (1000, 0.3, 1.0)])
def test_clock_burst_sends_the_count_on_the_ticks(rate, period, seconds):
    spec = Spec(ROOT)
    arrivals = spec.module("arrivals", "clock_burst")
    mix = spec.mix("burst8600-3200", rate_per_s=rate, period_s=period)
    a = arrivals.schedule(mix, SEED, seconds)
    b = arrivals.schedule(mix, SEED + 1, seconds)
    assert len(a.due) == round(rate * seconds) == len(b.due)
    ticks = np.unique(a.due)
    assert np.allclose(ticks / period, np.round(ticks / period))
    assert ticks[0] == 0 and a.due.max() < seconds
    burst = round(rate * period)
    assert (np.bincount(np.round(a.due / period).astype(int))[:-1]
            == burst).all()
    # each stream's windows in order; seeds differ in the streams' order
    assert np.array_equal(a.due, b.due) and not np.array_equal(a.stream,
                                                               b.stream)
    for s in np.unique(a.stream)[:5]:
        assert (np.diff(a.k[a.stream == s]) == 1).all()


def test_pems_burst_cell_on_the_cpu():
    """The queued cell: the same system as pems-steady under the clock's
    bursts, correct at 0/0/0."""
    out, _ = run_cell("pems-burst", SEED, 2.0, False, device="cpu",
                      mix_overrides={"streams": 40, "rate_per_s": 300,
                                     "batch": 8})
    assert out["correct"] and out["attempted"] == 600
    assert 0 < out["metrics"]["windows_per_s"]["value"] <= 300


# the LFM2 cell's knee (PERF.md §6): one seed's rows of an earlier sweep
KNEE_ROWS = {
    140: dict(p90_first_fifth_ms=563.5, p90_last_fifth_ms=572.4,
              unanswered_share_at_close=0.01218, held_share=0.0),
    220: dict(p90_first_fifth_ms=636.3, p90_last_fifth_ms=666.0,
              unanswered_share_at_close=0.01266, held_share=0.0),
    260: dict(p90_first_fifth_ms=961.2, p90_last_fifth_ms=650.9,
              unanswered_share_at_close=0.01018, held_share=0.00596),
}


@pytest.mark.parametrize("rate,want", [(140, True), (220, True),
                                       (260, False)])
def test_knee_rule_reads_the_backlog_not_the_tail(rate, want):
    """``knee.py`` keeps the rates whose turns in flight at the close are
    what their latency holds (which ``sweep.py``'s 1% rule refuses for
    half-second tails) and refuses held submits; a backlog that grows
    through the window fails it."""
    from perfbench.knee import sustained
    row = dict(KNEE_ROWS[rate], seconds=51.0, correct=True, failed=0)
    assert sustained(row, 1.5) is want
    assert row["unanswered_share_at_close"] >= 0.01   # sweep.py's refusal
    grown = dict(row, held_share=0.0, unanswered_share_at_close=0.05)
    assert not sustained(grown, 1.5)
    late = dict(row, held_share=0.0,
                p90_last_fifth_ms=2 * row["p90_first_fifth_ms"])
    assert not sustained(late, 1.5)
