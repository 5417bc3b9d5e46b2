"""Performance and energy model of one NVIDIA H100 — the paper's evaluation
method (C5), counterpart of ``repro/core/energy.py`` with the card's own
constants.

The paper scores configurations by GOP/s (throughput) and GOP/s/W (energy
efficiency), splitting power into STATIC (drawn whatever the work) and
DYNAMIC (proportional to activity).  On the card:

  P_total(t) = P_STATIC + E_dynamic / t
  E_dynamic  = e_mxu|vpu * ops  +  e_hbm * hbm_bytes  +  e_ici * ici_bytes

The functions and the constants' names are the reference's; every
function reads the constants when it is called, so a test can patch them.

Peaks (NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W
limit): the tensor cores run bf16 at 989 TFLOP/s and int8 at 1,979 TOP/s;
device memory (HBM3) moves 3.35 TB/s; NVLink 4 (what ``ICI_*`` means on
this card) has 18 links of 50 GB/s, 25 GB/s each way.  ``vpu`` is the
CUDA-core int32 datapath, the unit the port's integer LSTM kernels run
on: 132 SMs x 64 int32 lanes x 2 operations (a multiply-add) x 1.98 GHz
boost clock = 33.45 TOP/s, worked out from the data sheet's SM count and
clock and the Hopper white paper's 64 int32 lanes per SM.

Power: ``P_STATIC_W`` is the board's idle draw and the per-op and
per-byte energies are fits of the draw above idle during sustained
loops, all read with ``nvidia-smi --query-gpu=power.draw`` at ~10 Hz by
``chip_smoke.py`` phase 9c on an NVIDIA H100 80GB HBM3 with a 700.00 W
power limit (the readings are in ``PERF.md``):

  * e_hbm: K6 (``hard_tanh``) on a 1 GiB int8 tensor (bytes-bound): the
    whole draw above idle over its bytes a second, its clamp
    instructions included;
  * e_vpu: K1 (``qlstm_seq_multilayer``) at a batch of 2^20, per model
    operation (``ops_per_inference``'s count), so it carries the kernel's
    own overheads: an estimate of joules per useful operation, not of one
    int32 instruction;
  * e_mxu int8: K4 (``quant_matmul``) on an 8192^3 int8 product;
  * e_mxu bf16: a bf16 ``torch.matmul`` of the same size, a calibration
    reading only (the port runs no bf16 product of its own here);

the last three with their bytes' share (e_hbm) taken out.

Both tensor-core loops run at the 700 W limit, so each term is the
energy per operation of that kernel at the cap: K4 reaches a quarter of
the int8 peak and PyTorch's bf16 product two thirds of the bf16 one,
which makes the int8 term the larger here — unlike the paper's C1
argument, which holds per operation at equal efficiency.  Every energy
term is therefore an ESTIMATE: a two-point fit of a 1 s averaged board
reading, with static power assumed flat under load (it rises with
temperature and clock, and the fit books that rise as dynamic energy).
``E_ICI_J_PER_BYTE`` is not measured — one card has no NVLink peer — and
is set equal to the device-memory term as a placeholder; no report of
the port uses it (``ici_bytes=0``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# --- Roofline peaks (NVIDIA H100 SXM data sheet, dense) --------------------
PEAK_BF16_FLOPS = 989e12          # bf16 tensor cores, per card
PEAK_INT8_OPS = 1979e12           # int8 tensor cores, per card
PEAK_VPU_FLOPS = 132 * 64 * 2 * 1.98e9   # CUDA-core int32 MAC: 33.45 TOP/s
HBM_BW = 3.35e12                  # bytes/s, HBM3
ICI_BW_PER_LINK = 25e9            # bytes/s each way, one NVLink 4 link
ICI_LINKS = 18                    # NVLink 4 links per H100 SXM

# --- Energy model constants (NVIDIA H100 80GB HBM3, 700.00 W limit;
# chip_smoke.py phase 9c; estimates, see the docstring) ----------------------
P_STATIC_W = 130.40               # board idle draw
E_MXU_BF16_J_PER_FLOP = 0.783e-12   # bf16 matmul at 677.6 TFLOP/s, 697.7 W
E_MXU_INT8_J_PER_OP = 1.081e-12     # K4 at 495.3 TOP/s, 692.9 W
E_VPU_J_PER_FLOP = 128.3e-12        # K1 at 1.591 TOP/s of model ops, 339.3 W
E_HBM_J_PER_BYTE = 148.1e-12        # K6 at 2.748 TB/s, 537.3 W
E_ICI_J_PER_BYTE = E_HBM_J_PER_BYTE   # not measured: placeholder


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds (per device)."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: terms overlap perfectly -> max()."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def step_s_serial(self) -> float:
        """Upper-bound step time: no overlap -> sum()."""
        return self.compute_s + self.memory_s + self.collective_s

    def asdict(self) -> Dict:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "bound": self.bound,
                "step_s": self.step_s}


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   unit: str = "mxu", dtype: str = "bf16",
                   ici_links: Optional[int] = None) -> RooflineTerms:
    """Per-device terms from per-device operation and byte counts
    (``ici_links`` defaults to :data:`ICI_LINKS`)."""
    if unit == "vpu":
        peak = PEAK_VPU_FLOPS
    elif dtype == "int8":
        peak = PEAK_INT8_OPS
    else:
        peak = PEAK_BF16_FLOPS
    links = ICI_LINKS if ici_links is None else ici_links
    return RooflineTerms(
        compute_s=flops / peak,
        memory_s=hbm_bytes / HBM_BW,
        collective_s=collective_bytes / (ICI_BW_PER_LINK * links),
    )


def dynamic_energy_j(flops: float, hbm_bytes: float, ici_bytes: float = 0.0,
                     unit: str = "mxu", dtype: str = "bf16") -> float:
    if unit == "vpu":
        e_op = E_VPU_J_PER_FLOP
    elif dtype == "int8":
        e_op = E_MXU_INT8_J_PER_OP
    else:
        e_op = E_MXU_BF16_J_PER_FLOP
    return e_op * flops + E_HBM_J_PER_BYTE * hbm_bytes + E_ICI_J_PER_BYTE * ici_bytes


def power_report(flops: float, hbm_bytes: float, ici_bytes: float,
                 latency_s: float, unit: str = "mxu",
                 dtype: str = "bf16") -> Dict:
    """The paper's Table-4 row: static/dynamic/total power, energy/inference,
    throughput and energy efficiency."""
    e_dyn = dynamic_energy_j(flops, hbm_bytes, ici_bytes, unit, dtype)
    e_static = P_STATIC_W * latency_s
    p_dyn = e_dyn / latency_s if latency_s > 0 else 0.0
    gops = flops / latency_s / 1e9 if latency_s > 0 else 0.0
    p_total = P_STATIC_W + p_dyn
    return {
        "static_w": P_STATIC_W,
        "dynamic_w": p_dyn,
        "total_w": p_total,
        "latency_s": latency_s,
        "energy_j": e_dyn + e_static,
        "throughput_gops": gops,
        "gops_per_watt": gops / p_total if p_total > 0 else 0.0,
    }


def model_flops_train(n_params: float, n_tokens: float,
                      n_active_params: Optional[float] = None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE)."""
    n = n_active_params if n_active_params is not None else n_params
    return 6.0 * n * n_tokens


def model_flops_decode(n_params: float, n_tokens: float,
                       n_active_params: Optional[float] = None) -> float:
    """2*N per generated token (forward only)."""
    n = n_active_params if n_active_params is not None else n_params
    return 2.0 * n * n_tokens
