"""The control of the comparison: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states, must come out as not correct.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 --seconds 10

For each seed it makes the requests a run of the cell would send in
``--seconds`` (its mix's arrivals, the system's ``payload``), runs the
configuration's reference once as the configuration states it and once
a step below (``predict(..., lower=True)``: for ``reference/qlstm.py``,
``(a/2, b/2)``, int8 codes for int16 ones, int4 for int8), and prints
the comparison's numbers for the second, as the program would answer
(the reference's ``answers``, else ``compare.answers``), against the
first.  The benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from perfbench import compare  # noqa: E402
from perfbench.bench import Spec  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device="cpu",
             root=None, mix_overrides=None):
    spec = Spec(root) if root else Spec()
    cfg = spec.config(spec.workload(workload)["config"])
    system = spec.module("systems", cfg["system"])
    reference = spec.module("reference", cfg["reference"])
    mix = spec.mix(spec.workload(workload)["traffic"], system,
                   **(mix_overrides or {}))
    sched = spec.module("arrivals", mix.arrivals).schedule(mix, seed, seconds)
    stream, k = sched.stream, sched.k
    x = system.payload(cfg, mix, seed).take(stream, k)
    w = system.make_weights(cfg, seed, device)
    want = reference.predict(cfg, w, stream, k, x, device=device)
    ctrl = reference.predict(cfg, w, stream, k, x, device=device, lower=True)
    y = getattr(reference, "answers", compare.answers)(*ctrl)
    return {"workload": workload, "seed": seed, "windows": len(stream),
            **compare.read(reference, y, want)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds,
                                  args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
