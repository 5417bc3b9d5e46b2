"""The port's energy model (``repro_torch.core.energy``), ``Accelerator.
report``, the serving tier's GOP/s/W and ``analysis/report.py``, held
against the reference.

  * the reference's energy tests, restated at the H100's constants;
  * every function with the port's constants patched to the reference's
    values equals the reference's within rel 1e-12 (the formulas are the
    same; only the constants differ);
  * ``report()`` has the reference's keys and, outside ``energy``, its
    values over the 12 ``compute_unit`` x ``hs_method`` x ``alu_mode``
    configs (``plan.mxu_fill_fraction`` is ``None`` in the port by
    design); ``energy`` is the reference's formula on the CUDA-core
    (``vpu``) terms for both units — the unit the port's kernel runs on;
  * ``metrics_summary()["gops_per_watt"]`` is ``report()`` at the measured
    operating point;
  * every table of ``analysis/report.py`` renders byte for byte as the
    reference's from the same payload."""

import contextlib
import io
import itertools
import json
import sys

import numpy as np
import pytest

import repro_torch
from repro_torch.analysis import report as treport
from repro_torch.convert import params_from_reference
from repro_torch.core import energy
from repro_torch.core.accelerator import ALU_MODES, HS_METHODS, AcceleratorConfig
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.serving import StreamServer

try:  # the JAX reference; the card's machine has none
    import jax
    import repro
    from repro.analysis import report as jreport
    from repro.core import energy as jenergy
except ImportError:
    jax = None

REL = 1e-12
CONSTANTS = ("PEAK_BF16_FLOPS", "PEAK_INT8_OPS", "PEAK_VPU_FLOPS", "HBM_BW",
             "ICI_BW_PER_LINK", "ICI_LINKS", "P_STATIC_W",
             "E_MXU_BF16_J_PER_FLOP", "E_MXU_INT8_J_PER_OP",
             "E_VPU_J_PER_FLOP", "E_HBM_J_PER_BYTE", "E_ICI_J_PER_BYTE")


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def reference_constants(reference, monkeypatch):
    """The port's constants set to the reference's values."""
    for name in CONSTANTS:
        monkeypatch.setattr(energy, name, getattr(jenergy, name))


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


def _same_dict(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], str):
            assert a[k] == b[k], k
        else:
            assert _close(a[k], b[k]), (k, a[k], b[k])


# ---------------------------------------------------------------------------
# The reference's energy tests at the H100's constants
# ---------------------------------------------------------------------------

def test_roofline_terms_and_bound():
    t = energy.roofline_terms(flops=989e12, hbm_bytes=0, collective_bytes=0)
    assert t.compute_s == pytest.approx(1.0)
    assert t.bound == "compute"
    t2 = energy.roofline_terms(flops=0, hbm_bytes=3.35e12, collective_bytes=0)
    assert t2.memory_s == pytest.approx(1.0)
    assert t2.bound == "memory"
    assert energy.roofline_terms(1979e12, 0, 0, dtype="int8").compute_s \
        == pytest.approx(1.0)
    assert energy.roofline_terms(33.45e12, 0, 0, unit="vpu").compute_s \
        == pytest.approx(1.0, rel=1e-3)
    t3 = energy.roofline_terms(0, 0, collective_bytes=450e9)
    assert t3.collective_s == pytest.approx(1.0) and t3.bound == "collective"
    assert t3.step_s == t3.step_s_serial == pytest.approx(1.0)
    assert set(t3.asdict()) == {"compute_s", "memory_s", "collective_s",
                                "bound", "step_s"}


def test_power_report_static_dynamic_split():
    rep = energy.power_report(flops=1e12, hbm_bytes=1e9, ici_bytes=0,
                              latency_s=0.01, dtype="int8")
    assert rep["static_w"] == energy.P_STATIC_W
    assert rep["total_w"] > rep["static_w"]
    assert rep["gops_per_watt"] > 0
    # Each dtype is scored by its own measured term.  On the card the int8
    # term (K4 at the 700 W cap) exceeds the bf16 one (PyTorch's bf16
    # product at the cap), so the reference's C1 ordering is not asserted.
    rep_bf16 = energy.power_report(flops=1e12, hbm_bytes=1e9, ici_bytes=0,
                                   latency_s=0.01, dtype="bf16")
    for r, e in ((rep, energy.E_MXU_INT8_J_PER_OP),
                 (rep_bf16, energy.E_MXU_BF16_J_PER_FLOP)):
        assert r["dynamic_w"] == pytest.approx(
            (e * 1e12 + energy.E_HBM_J_PER_BYTE * 1e9) / 0.01)
    # the CUDA-core integer datapath the LSTM kernels run on
    rep_vpu = energy.power_report(flops=1e12, hbm_bytes=1e9, ici_bytes=0,
                                  latency_s=0.01, unit="vpu")
    assert rep_vpu["dynamic_w"] == pytest.approx(
        (energy.E_VPU_J_PER_FLOP * 1e12 + energy.E_HBM_J_PER_BYTE * 1e9)
        / 0.01)


def test_model_flops():
    assert energy.model_flops_train(1e9, 1e6) == 6e15
    assert energy.model_flops_decode(1e9, 128) == pytest.approx(2.56e11)
    assert energy.model_flops_train(1e9, 1e6, n_active_params=1e8) == 6e14


def test_constants_are_read_at_call_time(monkeypatch):
    monkeypatch.setattr(energy, "P_STATIC_W", 1.0)
    monkeypatch.setattr(energy, "ICI_LINKS", 1)
    assert energy.power_report(0, 0, 0, 1.0)["static_w"] == 1.0
    assert energy.roofline_terms(0, 0, energy.ICI_BW_PER_LINK).collective_s \
        == 1.0


# ---------------------------------------------------------------------------
# The same formulas: the reference's constants in, the reference's numbers out
# ---------------------------------------------------------------------------

CASES = [(1e12, 1e9, 0.0, 0.01), (3.7e9, 2.2e6, 5e5, 2.5e-4),
         (1.0, 0.0, 0.0, 28.07e-6), (0.0, 0.0, 0.0, 0.0)]
UNITS = [("mxu", "bf16"), ("mxu", "int8"), ("vpu", "bf16"), ("vpu", "int8")]


@pytest.mark.parametrize("flops,hbm,ici,lat", CASES)
def test_functions_equal_reference_with_its_constants(
        reference_constants, flops, hbm, ici, lat):
    for unit, dtype in UNITS:
        _same_dict(energy.power_report(flops, hbm, ici, lat, unit, dtype),
                   jenergy.power_report(flops, hbm, ici, lat, unit, dtype))
        assert _close(energy.dynamic_energy_j(flops, hbm, ici, unit, dtype),
                      jenergy.dynamic_energy_j(flops, hbm, ici, unit, dtype))
        _same_dict(energy.roofline_terms(flops, hbm, ici, unit, dtype).asdict(),
                   jenergy.roofline_terms(flops, hbm, ici, unit, dtype).asdict())
    for links in (1, 7):
        _same_dict(energy.roofline_terms(flops, hbm, ici, ici_links=links)
                   .asdict(),
                   jenergy.roofline_terms(flops, hbm, ici, ici_links=links)
                   .asdict())
    assert energy.model_flops_train(flops, hbm) == \
        jenergy.model_flops_train(flops, hbm)
    assert energy.model_flops_decode(flops, hbm) == \
        jenergy.model_flops_decode(flops, hbm)


# ---------------------------------------------------------------------------
# Accelerator.report against the reference over the Table-2 configs
# ---------------------------------------------------------------------------

CONFIGS = list(itertools.product(("mxu", "vpu"), HS_METHODS, ALU_MODES))


@pytest.mark.parametrize("unit,hs,alu", CONFIGS)
def test_report_matches_reference(reference_constants, unit, hs, alu):
    kw = dict(compute_unit=unit, hs_method=hs, alu_mode=alu)
    js = repro.build(repro.core.qlstm.QLSTMConfig(hidden_size=8, num_layers=2),
                     repro.core.accelerator.AcceleratorConfig(**kw),
                     seed=4).quantize()
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, js.params))
    ts = repro_torch.build(QLSTMConfig(hidden_size=8, num_layers=2),
                           AcceleratorConfig(**kw), params=params,
                           device="cpu").quantize()
    for lat, batch in ((repro_torch.api.PAPER_LATENCY_S, 1), (3.1e-4, 64)):
        args = () if batch == 1 else (lat, batch)
        got, want = ts.report(*args), js.report(*args)
        assert set(got) == set(want)
        plan, jplan = dict(got["plan"]), dict(want["plan"])
        assert plan.pop("mxu_fill_fraction") is None
        jplan.pop("mxu_fill_fraction")
        assert plan == jplan
        for k in ("model", "backend", "backends_supported",
                  "stateful_backends", "ops_per_inference", "weight_bytes",
                  "quantized"):
            assert got[k] == want[k], k
        # Both units are scored on the CUDA-core terms of the formula.
        _same_dict(got["energy"], jenergy.power_report(
            flops=want["ops_per_inference"] * batch,
            hbm_bytes=want["weight_bytes"], ici_bytes=0, latency_s=lat,
            unit="vpu", dtype="int8" if ts.accel.fxp.total_bits <= 8
            else "bf16"))
        if unit == "vpu":
            _same_dict(got["energy"], want["energy"])
    assert repro_torch.api.PAPER_LATENCY_S == repro.api.PAPER_LATENCY_S


def test_report_keys_and_default_operating_point():
    s = repro_torch.build(device="cpu")
    r = s.report()
    assert not r["quantized"] and r["energy"]["latency_s"] == 28.07e-6
    assert r["energy"]["static_w"] == energy.P_STATIC_W
    assert r["ops_per_inference"] > 0 and r["energy"]["total_w"] > 0
    assert r["plan"]["fxp"] == {"frac_bits": 4, "total_bits": 8, "signed": True}
    json.dumps(r)                      # JSON-friendly, as the reference's


# ---------------------------------------------------------------------------
# Serving GOP/s/W: report() at the measured operating point
# ---------------------------------------------------------------------------

def _windows(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, 6, 1)) * 0.5
            ).astype(np.float32)


def test_metrics_summary_gops_per_watt_is_report_at_operating_point():
    sess = repro_torch.build(QLSTMConfig(hidden_size=8), seed=1,
                             device="cpu").quantize()
    with StreamServer(sess, batch=4, deadline_s=None, max_streams=16) as srv:
        for i, w in enumerate(_windows(10, seed=2)):
            srv.submit(f"s{i % 3}", w)
        srv.drain(timeout=120)
        s = srv.metrics_summary()
    rep = sess.report(latency_s=s["compute_ms_mean"] / 1e3,
                      batch=round(s["mean_occupancy"]))
    assert s["gops_per_watt"] == rep["energy"]["gops_per_watt"] > 0
    assert s["energy"] == rep["energy"]
    assert s["ops_per_inference"] == rep["ops_per_inference"]


# ---------------------------------------------------------------------------
# analysis/report.py: the reference's tables, byte for byte
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def payloads(tmp_path_factory):
    """An offline and a serving sweep payload of the port, a serving
    artifact in the reference's BENCH_serving schema built from the port's
    own summaries (one server, one two-replica cluster), and dry-run rows
    with a baseline."""
    from repro_torch import explore
    offline = explore.sweep(
        explore.SearchSpace(alu_mode=("pipelined", "per_step"),
                            backend=("auto", "pallas"), batch=4,
                            hidden_size=8),
        iters=1, device="cpu")
    serving = explore.sweep(
        explore.SearchSpace(batch=(1, 4), hidden_size=8, replicas=(1, 2)),
        scenario=explore.ServingScenario(streams=2, windows_per_stream=2,
                                         deadline_ms=60000.0),
        strategy="halving", constraint="p99_ms<=60000", device="cpu")
    sess = repro_torch.build(QLSTMConfig(hidden_size=8), device="cpu") \
        .quantize()
    scenarios = {}
    for name, n in (("one", 1), ("cluster[r2]", 2)):
        srv = (StreamServer(sess, batch=2, deadline_s=None) if n == 1 else
               repro_torch.build_cluster(sess, n, batch=2, deadline_s=None))
        try:
            for i, w in enumerate(_windows(6, seed=3)):
                srv.submit(f"s{i % 3}", w)
            srv.drain(timeout=120)
            s = srv.metrics_summary()
        finally:
            srv.close()
        s.update(batch=2, backend=s["faults"]["backend"],
                 vs_paper_samples_per_s=s["samples_per_s"] / 32873.0)
        for p in (s.get("replicas") or {}).values():
            p.setdefault("batch", 2)
        scenarios[name] = s
    bench = {"paper": {"samples_per_s": 32873.0, "gops_per_watt": 11.89},
             "scenarios": scenarios}
    roof = lambda c, m, k: {"compute_s": c, "memory_s": m,  # noqa: E731
                            "collective_s": k, "step_s": max(c, m, k),
                            "bound": max((c, "compute"), (m, "memory"),
                                         (k, "collective"))[1]}
    dry = [dict(arch=a, shape=sh, mesh=mesh, status="ok", kind=kind,
                compile_s=1.5, params=5e8,
                memory={"peak_gb": pk}, collectives={"total": 3 * 2**20},
                microbatches=2, useful_flops_ratio=u,
                roofline=roof(c, m, k))
           for a, sh, mesh, kind, pk, u, c, m, k in (
               ("qwen", "train", "16x16", "train", 7.5, 0.4, 0.3, 0.1, 0.01),
               ("qwen", "decode", "16x16", "decode", 3.0, 0.9, 0.01, 0.2, 0.0),
               ("rg", "train", "16x16", "train", 9.0, 0.8, 0.2, 0.1, 0.05),
               ("rg", "train", "2x16x16", "train", 4.0, 0.8, 0.1, 0.1, 0.3))]
    dry.append(dict(arch="moe", shape="train", mesh="16x16", status="oom",
                    reason="x" * 90))
    base = json.loads(json.dumps(dry))
    base[0]["roofline"]["step_s"] = 0.5
    base[1]["memory"]["peak_gb"] = 5.0
    tmp = tmp_path_factory.mktemp("report")
    files = {}
    for name, obj in (("pareto", offline), ("serving_pareto", serving),
                      ("serving", bench), ("dryrun", dry), ("base", base)):
        files[name] = tmp / f"{name}.json"
        files[name].write_text(json.dumps(obj))
    return {k: json.loads(v.read_text()) for k, v in files.items()}, files


def test_report_tables_match_reference(reference, payloads):
    p, _ = payloads
    assert {r["status"] for r in p["pareto"]["points"]} == \
        {"ok", "unsupported"}
    assert {r["status"] for r in p["serving_pareto"]["points"]} == \
        {"ok", "infeasible"}
    for name in ("pareto", "serving_pareto"):
        got = treport.pareto_table(p[name])
        assert got == jreport.pareto_table(p[name]) and "| config |" in got
    got = treport.serving_table(p["serving"])
    assert got == jreport.serving_table(p["serving"])
    assert "Cluster breakdown" in got and "Reliability" in got
    for mesh in ("16x16", "2x16x16"):
        assert treport.dryrun_table(p["dryrun"], mesh) == \
            jreport.dryrun_table(p["dryrun"], mesh)
    assert treport.roofline_table(p["dryrun"]) == \
        jreport.roofline_table(p["dryrun"])
    got = treport.perf_delta_table(p["dryrun"], p["base"])
    assert got == jreport.perf_delta_table(p["dryrun"], p["base"])
    assert got.count("\n") >= 3


@pytest.mark.parametrize("argv", [["--pareto", "pareto"],
                                  ["--pareto", "serving_pareto"],
                                  ["--serving", "serving"],
                                  ["dryrun", "--baseline", "base"]])
def test_report_main_matches_reference(reference, payloads, monkeypatch, argv):
    _, files = payloads
    args = [str(files[a]) if a in files else a for a in argv]
    outs = []
    for mod in (jreport, treport):
        monkeypatch.setattr(sys, "argv", ["report", *args])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[0].startswith("## ")
