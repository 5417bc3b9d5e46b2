"""``moe_share``: the share (%) of the device's busy time in the traced
sub-window spent on the MoE layers' operations: the union of the device
operations that ran between a ``lfm2.moe`` section's two marks
(``SessionServer``'s probe with ``marks`` on: a fill of an int16 element
before the section's first operation, of a complex64 one after its
last; one stream, so the device runs a section's operations between
them), over the union of every device operation there.  Idle time
counts on neither side, and the MoE's operations are some of the
device's, so the share is at most 100%.  Nothing where no mark ran."""

from perfbench.trace import _union

BEGIN, END = "FillFunctor<short>", "FillFunctor<c10::complex<float>"


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.busy_s <= 0:
        return None
    marks = [(BEGIN in name) - (END in name) for name, _, _ in tr.ops]
    first = next((m for m in marks if m), 0)
    if not first:
        return None
    inside, moe = first < 0, []
    for (_, s, e), m in zip(tr.ops, marks):
        if m:
            inside = m > 0
        elif inside:
            moe.append((s, e))
    busy = _union(moe, tr.t_a, tr.t_b)
    return 100.0 * sum(e - s for s, e in busy) / tr.busy_s
