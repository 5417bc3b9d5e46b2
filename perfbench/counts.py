"""Operations and bytes the benchmark counts, and the chip's peaks.

The operation count per window is the paper's (§4, Eq. 7: a MAC is two
operations), the convention behind its GOP/s and GOP/s/W; the bytes of
one slot-kernel launch (K3, ``qlstm_rows_kernel<T, true>``) are counted
from its shapes: each input byte read once and each output byte written
once.  Peaks are NVIDIA's H100 SXM data sheet (dense rates), which
assume the card's full 700 W power limit.
"""

from __future__ import annotations

# H100 SXM data sheet: device memory bandwidth, and the CUDA cores'
# float32 rate.  The LSTM's integer MACs run on the CUDA cores (no
# tensor-core path), and the data sheet gives no int32 rate, so the
# float32 rate stands for the CUDA cores' peak.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def lstm_ops(m: int, h: int, layers: int, t: int) -> int:
    """Operations of the LSTM layers for one window of ``t`` steps: gate
    MACs, bias adds, the three element products and one add, and one
    operation per activation."""
    total = 0
    for li in range(layers):
        k_in = m if li == 0 else h
        per_step = 2 * 4 * h * (k_in + h) + 4 * h + 2 * 3 * h + h + 4 * h
        total += t * per_step
    return total


def ops_per_window(m: int, h: int, layers: int, t: int, p: int) -> int:
    """Operations for one window: the LSTM plus the dense head (22,001
    for the paper's M=1, H=20, L=1, T=6, P=1)."""
    return lstm_ops(m, h, layers, t) + 2 * h * p + p


def code_bytes(bits: int) -> int:
    """Bytes of one stored code of ``bits`` bits (int8, int16, int32)."""
    return 1 if bits <= 8 else 2 if bits <= 16 else 4


def k3_bytes(m: int, h: int, layers: int, t: int, bits: int, batch: int,
             table_rows: int = 0) -> int:
    """Bytes one K3 launch moves at wave size ``batch``: the input codes
    (T, B, M), the weights (codes) and biases (int32), the two (B,) int32
    slot-id vectors, the B table rows gathered and the B rows scattered
    ((L, 2, H) int32 each), and the (T, B, H) output codes.
    ``table_rows`` > 0 counts the whole table read and written instead
    of the wave's rows (the way the earlier bound in the repository's
    kernel table counted it)."""
    cb = code_bytes(bits)
    w = sum((m if li == 0 else h) * 4 * h + h * 4 * h
            for li in range(layers)) * cb + layers * 4 * h * 4
    row = layers * 2 * h * 4
    rows = 2 * (table_rows if table_rows else batch) * row
    return t * batch * m * cb + w + 2 * batch * 4 + rows + t * batch * h * cb


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: bytes over the memory rate or
    operations over the CUDA cores' rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S)
