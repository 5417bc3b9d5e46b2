"""``k3_roofline``: the slot kernel K3 (``qlstm_rows_kernel<T, true>``,
``csrc/qlstm_cell.cu``) against its bound, in %: the least time for one
launch at the wave size (``perfbench/counts.py``: the wave's bytes at
the memory rate, its operations at the CUDA cores' rate) over the
profiler's mean time of the kernel in the traced sub-window.  Nothing
when the kernel did not run there."""

from perfbench import counts

SYMBOL = "qlstm_rows_kernel"


def read(run):
    if run.trace is None:
        return None
    times = run.trace.kernel_times(SYMBOL)
    if not times:
        return None
    m, h, layers, t, _ = run.dims
    nbytes = counts.k3_bytes(m, h, layers, t, run.bits, run.batch)
    ops = counts.lstm_ops(m, h, layers, t) * run.batch
    return 100.0 * counts.bound_s(nbytes, ops) / (sum(times) / len(times))
