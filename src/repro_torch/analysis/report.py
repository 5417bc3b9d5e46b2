"""Render sweep JSON artifacts into markdown tables — counterpart of
``repro/analysis/report.py`` (a copy: the payloads are plain JSON, and the
tables are byte for byte the reference's).

Dry-run sweeps (the reference's ``launch/dryrun.py`` output, plus deltas
vs a baseline):

  PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun.json \
      [--baseline results/dryrun_baseline.json]

Design-space sweeps (the payload of ``repro_torch.explore.sweep`` saved as
JSON; Pareto-front rows are bolded):

  PYTHONPATH=src python -m repro_torch.analysis.report --pareto BENCH_pareto.json

Serving runs (the reference's ``BENCH_serving.json`` schema; one row per
scenario, scored against the paper's §6 headline):

  PYTHONPATH=src python -m repro_torch.analysis.report --serving BENCH_serving.json
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024:
            return f"{b:.2f} {unit}"
        b /= 1024
    return f"{b:.2f} PiB"


def _ms(s: float) -> str:
    return f"{s * 1e3:.2f}"


def dryrun_table(rs: List[Dict], mesh: str) -> str:
    rows = [r for r in rs if r.get("mesh") == mesh]
    out = [f"| arch | shape | status | compile s | params | peak GB/dev | "
           f"coll MB/dev | microbatches |",
           "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} "
                       f"({r.get('reason', '')[:60]}...) | | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | ok | {r.get('compile_s', '')} | "
            f"{r.get('params', 0) / 1e9:.2f}B | "
            f"{r['memory'].get('peak_gb', 0):.2f} | "
            f"{r['collectives'].get('total', 0) / 2**20:.1f} | "
            f"{r.get('microbatches', '-')} |")
    return "\n".join(out)


def roofline_table(rs: List[Dict]) -> str:
    rows = [r for r in rs if r.get("mesh") == "16x16" and r["status"] == "ok"]
    out = ["| arch | shape | compute ms | memory ms | collective ms | bound "
           "| step ms | MODEL_FLOPS/HLO | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        t = r["roofline"]
        note = _bottleneck_note(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {_ms(t['compute_s'])} | "
            f"{_ms(t['memory_s'])} | {_ms(t['collective_s'])} | "
            f"**{t['bound']}** | {_ms(t['step_s'])} | "
            f"{(r.get('useful_flops_ratio') or 0):.2f} | {note} |")
    return "\n".join(out)


def _bottleneck_note(r: Dict) -> str:
    b = r["roofline"]["bound"]
    if b == "compute":
        u = r.get("useful_flops_ratio") or 0
        if u < 0.6:
            return ("cut remat/masked-rectangle waste (causal-aware "
                    "chunking, remat policy)")
        return "raise MXU util (larger microbatch, fused kernels)"
    if b == "memory":
        if r["kind"] == "decode":
            return "int8 weights + int8 KV (C1) halve/quarter traffic"
        return "fewer weight re-reads (fewer microbatches) / bf16 master"
    return "reshard to kill the dominant gather (see §Perf)"


def perf_delta_table(rs: List[Dict], base: List[Dict]) -> str:
    key = lambda r: (r["arch"], r["shape"], r["mesh"])
    bmap = {key(r): r for r in base if r.get("status") == "ok"}
    out = ["| cell | mesh | step ms before | after | coll MB before | after "
           "| peak GB before | after |",
           "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rs, key=key):
        if r.get("status") != "ok":
            continue
        b = bmap.get(key(r))
        if not b:
            continue
        t, tb = r["roofline"], b["roofline"]
        if abs(t["step_s"] - tb["step_s"]) / max(tb["step_s"], 1e-12) < 0.02 \
           and abs(r["memory"]["peak_gb"] - b["memory"]["peak_gb"]) < 0.5:
            continue  # only show meaningful deltas
        out.append(
            f"| {r['arch']} {r['shape']} | {r['mesh']} | {_ms(tb['step_s'])} "
            f"| **{_ms(t['step_s'])}** | "
            f"{b['collectives'].get('total', 0) / 2**20:.0f} | "
            f"**{r['collectives'].get('total', 0) / 2**20:.0f}** | "
            f"{b['memory'].get('peak_gb', 0):.1f} | "
            f"**{r['memory'].get('peak_gb', 0):.1f}** |")
    return "\n".join(out)


def pareto_table(payload: Dict) -> str:
    """The §Design-space table: one row per swept point, front rows bold.

    ``payload`` is the ``BENCH_pareto.json`` schema from
    ``repro.explore.sweep`` (see tests/test_explore.py).  Serving-aware
    payloads (schema v2 with a ``scenario``) get SLO columns — tail
    latency, deadline-miss rate, halving rung — instead of the offline
    energy/accuracy ones; an eliminated-everything sweep renders its
    ``front_reason`` instead of a silently empty front."""
    objectives = ", ".join(f"{k} ({v})"
                           for k, v in payload["objectives"].items())
    head = (f"Objectives: {objectives}.  Front: "
            f"{len(payload['front'])}/{len(payload['points'])} points.")
    if payload.get("constraint"):
        head += f"  SLO: {payload['constraint']}."
    if payload.get("scenario"):
        sc = payload["scenario"]
        head += (f"  Scenario: {sc.get('name', 'scenario')} "
                 f"({sc.get('streams')} streams x "
                 f"{sc.get('windows_per_stream')} windows, "
                 f"deadline {sc.get('deadline_ms')} ms, "
                 f"strategy={payload.get('strategy', 'full')}).")
    out = [head]
    if not payload["front"] and payload.get("front_reason"):
        out.append(f"Empty front: {payload['front_reason']}")
    out.append("")
    if payload.get("scenario"):
        return "\n".join(out + _serving_pareto_rows(payload))
    out += ["| config | backend | samples/s | GOP/s | GOP/s/W | total W | "
            "int-vs-float MSE | weights | front |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in payload["points"]:
        if r["status"] != "ok":
            out.append(f"| {r['label']} | — | {r['status']}: "
                       f"{r.get('reason', '')[:60]} | | | | | | |")
            continue
        m = r["metrics"]
        b = "**" if r["pareto"] else ""
        out.append(
            f"| {b}{r['label']}{b} | {r['plan']['backend']} | "
            f"{m['samples_per_s']:,.0f} | {m['throughput_gops']:.3f} | "
            f"{m['gops_per_watt']:.4f} | {m['total_w']:.1f} | "
            f"{m['int_float_mse']:.2e} | {_fmt_bytes(m['weight_bytes'])} | "
            f"{'yes' if r['pareto'] else ''} |")
    return "\n".join(out)


def _serving_pareto_rows(payload: Dict) -> list:
    """The serving-mode rows of :func:`pareto_table`: achieved rate and
    tail latency against the SLO, plus which halving rung each point was
    last measured at (non-final rungs ran a truncated scenario)."""
    out = ["| config | backend | replicas | samples/s | p50 ms | p95 ms | "
           "p99 ms | miss rate | GOP/s/W | rung | front |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in payload["points"]:
        if r["status"] != "ok":
            out.append(f"| {r['label']} | — | {r['status']}: "
                       f"{r.get('reason', '')[:60]} | | | | | | | | |")
            continue
        m = r["metrics"]
        op = r.get("operating_point") or {}
        rung = op.get("rung")
        rung_s = "full" if op.get("final") else (
            f"r{rung}@{op.get('fraction', 0):g}" if rung is not None else "—")
        gpw = m.get("gops_per_watt")
        b = "**" if r["pareto"] else ""
        out.append(
            f"| {b}{r['label']}{b} | {r['plan']['backend']} | "
            f"{r['plan'].get('replicas', 1)} | {m['samples_per_s']:,.0f} | "
            f"{m['p50_ms']:.2f} | {m['p95_ms']:.2f} | {m['p99_ms']:.2f} | "
            f"{m['deadline_miss_rate']:.3f} | "
            + (f"{gpw:.4f}" if gpw is not None and gpw == gpw else "—")
            + f" | {rung_s} | {'yes' if r['pareto'] else ''} |")
    return out


def serving_table(payload: Dict) -> str:
    """The §Serving table: one row per scenario from ``BENCH_serving.json``
    (see ``benchmarks/bench_serving.py`` for the schema), scored against
    the paper's §6 reference point."""
    paper = payload["paper"]
    out = [f"Paper reference (XC7S15 @ 204 MHz): "
           f"{paper['samples_per_s']:,.0f} samples/s, "
           f"{paper['gops_per_watt']:.2f} GOP/s/W.", "",
           "| scenario | backend | samples/s | vs paper | p50 ms | p95 ms | "
           "p99 ms | waves | occupancy | deadline flushes | evictions | "
           "GOP/s/W |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for name, s in payload["scenarios"].items():
        lat = s["latency_ms"]
        ev = (s.get("state") or {}).get("evictions", "—")
        out.append(
            f"| {name} | {s.get('backend', '—')} | "
            f"{s['samples_per_s']:,.0f} | "
            f"{s['vs_paper_samples_per_s']:.2f}x | {lat['p50']:.2f} | "
            f"{lat['p95']:.2f} | {lat['p99']:.2f} | {s['waves']} | "
            f"{s['mean_occupancy']:.1f}/{s['batch']} | "
            f"{s['deadline_flushes']} | {ev} | "
            f"{s['gops_per_watt']:.4f} |")
    fault_rows = _serving_fault_rows(payload)
    if fault_rows:
        out += ["", "Reliability (schema >= 3: the PR-6 guarded-execution "
                "layer; `injected` is the seeded chaos schedule that was "
                "absorbed):", "",
                "| scenario | served on | health | retries | wave failures |"
                " sheds | rejections | degradations | promotions | "
                "state resets | stream errors | injected faults |",
                "|---|---|---|---|---|---|---|---|---|---|---|---|"]
        out += fault_rows
    replica_rows = _serving_replica_rows(payload)
    if replica_rows:
        out += ["", "Cluster breakdown (schema >= 4: one row per replica "
                "of each `cluster[rN]` scenario; `aggregate samples/s` is "
                "the cluster's merged rate over the common wall, per-"
                "replica rates are each server's own):", "",
                "| scenario | replica | samples/s | p50 ms | p99 ms | "
                "waves | occupancy | streams |",
                "|---|---|---|---|---|---|---|---|"]
        out += replica_rows
    return "\n".join(out)


def _serving_fault_rows(payload: Dict) -> list:
    """§Serving reliability rows — one per scenario carrying a ``faults``
    block (empty for pre-PR-6 artifacts, keeping old JSONs renderable)."""
    rows = []
    for name, s in payload["scenarios"].items():
        f = s.get("faults")
        if f is None:
            continue
        inj = f.get("injected") or {}
        n_inj = sum(v for k, v in inj.items() if k != "attempts")
        health = (s.get("health") or {}).get("status", "—")
        rows.append(
            f"| {name} | {f['backend']}"
            f"{' (degraded)' if f['degraded'] else ''} | {health} | "
            f"{f['retries']} | {f['wave_failures']} | {f['sheds']} | "
            f"{f['rejections']} | {f['degradations']} | {f['promotions']} | "
            f"{f['state_resets']} | {f['stream_errors']} | {n_inj} |")
    return rows


def _serving_replica_rows(payload: Dict) -> list:
    """§Serving cluster rows — one per replica of each scenario carrying a
    ``replicas`` breakdown (the ClusterServer scenarios of schema >= 4;
    empty for single-server artifacts, keeping old JSONs renderable)."""
    rows = []
    for name, s in payload["scenarios"].items():
        per = s.get("replicas")
        if not per:
            continue
        for rname in sorted(per):
            p = per[rname]
            lat = p.get("latency_ms") or {}
            live = (p.get("state") or {}).get("live_streams", "—")
            occ = (f"{p['mean_occupancy']:.1f}/{p['batch']}"
                   if p.get("waves") else "—")
            rows.append(
                f"| {name} | {rname} | {p['samples_per_s']:,.0f} | "
                f"{lat.get('p50', 0):.2f} | {lat.get('p99', 0):.2f} | "
                f"{p['waves']} | {occ} | {live} |")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("results")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--pareto", action="store_true",
                    help="results is a BENCH_pareto.json design-space sweep")
    ap.add_argument("--serving", action="store_true",
                    help="results is a BENCH_serving.json serving run")
    args = ap.parse_args()
    rs = json.load(open(args.results))
    if args.pareto:
        print("## §Design-space — measured sweep + Pareto front\n")
        print(pareto_table(rs))
        return
    if args.serving:
        print("## §Serving — streaming subsystem vs the paper's §6 "
              "deployment\n")
        print(serving_table(rs))
        return
    print("## §Dry-run — single-pod 16x16 (256 chips)\n")
    print(dryrun_table(rs, "16x16"))
    print("\n## §Dry-run — multi-pod 2x16x16 (512 chips)\n")
    print(dryrun_table(rs, "2x16x16"))
    print("\n## §Roofline — single-pod, per-device terms\n")
    print(roofline_table(rs))
    if args.baseline:
        base = json.load(open(args.baseline))
        print("\n## §Perf — deltas vs baseline sweep\n")
        print(perf_delta_table(rs, base))


if __name__ == "__main__":
    main()
