"""``mfu``: the whole serving step's share of the chip's peak, in %: the
paper's operations of the windows answered in the traced sub-window,
over its wall, over the CUDA cores' data-sheet rate (H100 SXM, 67 T
operations a second at the 700 W power limit; ``perfbench/counts.py``).
Nothing when no device operation ran there."""

from perfbench import counts


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    done = run.done_between(tr.t_a, tr.t_b)
    rate = run.ops_per_window * done / tr.window_s
    return 100.0 * rate / counts.CUDA_CORE_OPS_PER_S
