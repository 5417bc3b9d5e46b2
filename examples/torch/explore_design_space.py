"""Design-space exploration through the PyTorch port: the paper's Table-4
comparison as a *search*, on the CUDA card unless ``--device cpu``.

Table 4 compares three hand-picked configurations — the [15] baseline
((8,16) fixed point, per-step ALU), "this work" on DSPs (MXU), and the
DSP-free variant (VPU).  The parameterised design makes that table one
slice of a space: here ``repro_torch.explore`` sweeps compute unit x ALU
mode x fixed-point format, scores every point by measured throughput,
modelled GOP/s/W and int-vs-float fidelity, prints the Pareto front, and
``autotune`` picks the deployment point under a power constraint.

Run:  PYTHONPATH=src python examples/torch/explore_design_space.py [--device cpu]
"""
import argparse

from repro_torch import explore
from repro_torch.analysis.report import pareto_table
from repro_torch.core.fixed_point import FXP_4_8, FXP_8_16


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    # The Table-4 axes; hs_method stays at the paper's 'step' and batch at 64.
    space = explore.SearchSpace(
        fxp=(FXP_4_8, FXP_8_16),
        compute_unit=("mxu", "vpu"),
        alu_mode=("pipelined", "per_step"),
        batch=(64,),
    )
    print(f"sweeping {space.size} configurations "
          f"(Table 4 compared 3 hand-picked ones)...\n")

    objectives = dict(explore.DEFAULT_OBJECTIVES, int_float_mse="min")
    result = explore.sweep(space, iters=args.iters, objectives=objectives,
                           log=print, device=args.device)
    print()
    print(pareto_table(result))

    # Deployment: maximise modelled energy efficiency under a power
    # envelope, reusing the sweep (payload=) instead of re-measuring.  The
    # cap sits just above the energy model's static board draw.
    session = explore.autotune(
        payload=result,
        objective="gops_per_watt",
        constraints={"total_w": (None, 140.0)},
        device=args.device,
    )
    best = session.autotune_summary["best"]
    print(f"\n[autotune] deployed point: {best['label']}")
    print(f"[autotune] {best['metrics']['samples_per_s']:,.0f} samples/s, "
          f"{best['metrics']['gops_per_watt']:.4f} GOP/s/W (modelled) "
          f"(paper's FPGA point: 32,873 samples/s, 11.89 GOP/s/W)")
    print(f"[autotune] session ready: {session!r}")
    return best


if __name__ == "__main__":
    main()
