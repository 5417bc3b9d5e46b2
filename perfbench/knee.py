"""Find a cell's knee where a request's latency is a sizeable part of the
window: ``sweep.py``'s runs, with the backlog at the close judged by
what the server holds in flight.

    python3 perfbench/knee.py --workload <name> --rates 200,230,260 --seeds 1,2 --seconds 51

``sweep.py`` takes a rate as sustained only where under 1% of the
window's arrivals are unanswered at its close.  A steady server holds
about ``rate * latency`` requests in flight, so that share is about
``latency / window``: with the LM's half-second turns in a 51 s window
it passes 1% at every rate, whether the backlog grows or not.  Here the
requests in flight at the close may be at most ``--growth`` times what
the first fifth's 90th percentile of latency holds at the offered rate
(``rate * p90``, by Little's law).  Every other rule is ``sweep.py``'s:
the run correct with no failed request, the last fifth's 90th
percentile at most ``--growth`` times the first fifth's, under 0.1% of
submits held back.  The knee is the highest rate sustained on every
seed; the sweep stops at the first rate not sustained on some seed.
The cell's rate is four fifths of the knee, rounded down to a whole
request a second.  It prints one JSON line a run, then the knee.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench.sweep import point  # noqa: E402


def sustained(row: dict, growth: float) -> bool:
    """``row`` (``sweep.point``'s) kept up with its rate."""
    first_s = row["p90_first_fifth_ms"] * 1e-3
    in_flight_s = row["unanswered_share_at_close"] * row["seconds"]
    return (row["correct"] and row["failed"] == 0
            and row["p90_last_fifth_ms"] <= growth * row["p90_first_fifth_ms"]
            and in_flight_s <= growth * first_s
            and row["held_share"] < 0.001)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seeds", default="1,2")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--growth", type=float, default=1.5)
    args = ap.parse_args()
    kept = []
    for rate in sorted(float(r) for r in args.rates.split(",")):
        rows = [point(args.workload, rate, args.seconds, int(s))
                for s in args.seeds.split(",")]
        for row in rows:
            row["sustained"] = sustained(row, args.growth)
            print(json.dumps(row), flush=True)
        if not all(r["sustained"] for r in rows):
            break
        kept.append(rate)
    knee = max(kept, default=None)
    print(json.dumps({"workload": args.workload, "knee_per_s": knee,
                      "rate_per_s": int(0.8 * knee) if knee else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
