"""A traced sub-window is read only where it is whole: every guarded
datapath span overlaps a device operation, and the spans saw the waves
the server counted."""

from perfbench.trace import TraceResult


def _trace(ops, paths, cuda=True):
    spans = [("server.datapath", s, e) for s, e in paths]
    return TraceResult(0.0, 1.0, ops, spans, cuda=cuda)


def test_a_whole_trace_is_read():
    tr = _trace([("k", 0.101, 0.102), ("k", 0.5003, 0.5004)],
                [(0.1, 0.103), (0.5, 0.501)])
    assert tr.fault(2) is None
    assert abs(tr.busy_s - 0.0011) < 1e-12


def test_a_wave_with_no_device_operation_refuses_the_trace():
    tr = _trace([("k", 0.101, 0.102)], [(0.1, 0.103), (0.5, 0.501)])
    assert "1 of 2 datapath spans" in tr.fault(2)


def test_spans_that_miss_the_counted_waves_refuse_the_trace():
    tr = _trace([("k", 0.101, 0.102)], [], cuda=False)
    assert "none of the 14 waves" in tr.fault(14)
    assert _trace([], [(0.1, 0.2)], cuda=False).fault(1) is None
