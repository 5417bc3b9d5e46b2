"""Find a cell's knee: the highest open-loop rate its system sustains.

    python3 perfbench/sweep.py --workload <name> --rates 3000,4000 --seeds 1,2 --seconds 51

runs the cell's mix at each rate, in rising order, once for each seed,
in one process (on the card), and prints one JSON line a run and then
the knee.  A rate is sustained on a seed where the run is correct with
no failed window, its backlog does not grow (the 90th percentile of
window latency, due to polled, over the windows due in the last fifth of
the window is at most ``--growth`` times that over the first fifth, and
under 1% of the window's arrivals are unanswered at its close), and
``submit`` is not held back (under 0.1% of submits take longer than
``bench.SUBMIT_HELD_S``).  It meets the latency target where the
window's 90th percentile is within ``--limit-ms`` as well.

The knee is the highest rate that meets the target on every seed, or,
where no rate does, the highest rate sustained on every seed.  The sweep
stops at the first rate not sustained on some seed.  The cell's rate is
four fifths of the knee, rounded down to a hundred; the benchmark's own
runs never search.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from perfbench.bench import SUBMIT_HELD_S, run_cell  # noqa: E402


def point(workload: str, rate: float, seconds: float, seed: int) -> dict:
    out, run = run_cell(workload, seed, seconds, False,
                        mix_overrides={"rate_per_s": rate})
    lat = run.done - run.due
    fifth = run.window_s / 5
    p90 = lambda sel: (float(np.percentile(lat[sel], 90)) * 1e3
                       if np.any(sel) else None)
    due = run.due_in_window()
    due_ok = due & run.ok
    return {
        "workload": workload, "rate_per_s": rate, "seed": seed,
        "seconds": seconds,
        "p90_ms": p90(due_ok),
        "p99_ms": float(np.percentile(lat[due_ok], 99)) * 1e3,
        "p90_first_fifth_ms": p90(due_ok & (run.due < run.t0 + fifth)),
        "p90_last_fifth_ms": p90(due_ok & (run.due >= run.t1 - fifth)),
        "gen_late_p99_ms": float(np.percentile(
            (run.sub - run.due)[due], 99)) * 1e3,
        "held_share": float(np.mean((run.ret - run.sub)[due]
                                    > SUBMIT_HELD_S)),
        "unanswered_share_at_close": float(np.count_nonzero(
            (run.sub < run.t1) & ~(run.done < run.t1)) / max(1, due.sum())),
        "answered_per_s": run.done_between(run.t0, run.t1) / run.window_s,
        "counters": run.counters,
        "failed": out["failed"], "correct": out["correct"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default="1,2")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--limit-ms", type=float, default=10.0)
    ap.add_argument("--growth", type=float, default=1.5)
    args = ap.parse_args()
    sustained, target = [], []
    for rate in sorted(float(r) for r in args.rates.split(",")):
        rows = [point(args.workload, rate, args.seconds, int(s))
                for s in args.seeds.split(",")]
        for row in rows:
            row["sustained"] = (
                row["correct"] and row["failed"] == 0
                and row["p90_last_fifth_ms"]
                <= args.growth * row["p90_first_fifth_ms"]
                and row["unanswered_share_at_close"] < 0.01
                and row["held_share"] < 0.001)
            row["meets_target"] = (row["sustained"]
                                   and row["p90_ms"] <= args.limit_ms)
            print(json.dumps(row), flush=True)
        if not all(r["sustained"] for r in rows):
            break
        sustained.append(rate)
        if all(r["meets_target"] for r in rows):
            target.append(rate)
    knee = max(target) if target else max(sustained, default=None)
    print(json.dumps({
        "workload": args.workload, "knee_per_s": knee,
        "by": "latency target" if target else "throughput",
        "rate_per_s": int(0.8 * knee // 100 * 100) if knee else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
