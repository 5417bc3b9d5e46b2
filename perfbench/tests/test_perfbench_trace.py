"""A traced sub-window is read only where it is whole: for a system that
names its datapath span, every such span overlaps a device operation,
and the spans saw the waves the server counted; for a system with no
spans, device operations were seen where requests were answered."""

from perfbench.systems import qlstm_server
from perfbench.trace import TraceResult


def _trace(ops, paths, cuda=True):
    spans = [(qlstm_server.DATAPATH, s, e) for s, e in paths]
    return TraceResult(0.0, 1.0, ops, spans, cuda=cuda,
                       datapath=qlstm_server.DATAPATH,
                       labels=qlstm_server.SPANS)


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


def test_a_system_with_no_spans_needs_device_operations_for_answers():
    bare = lambda ops, cuda=True: TraceResult(0.0, 1.0, ops, [], cuda=cuda)
    assert "5 requests answered" in bare([]).fault(0, answered=5)
    assert bare([]).fault(0, answered=0) is None
    assert bare([], cuda=False).fault(0, answered=5) is None
    assert bare([("k", 0.1, 0.2)]).fault(0, answered=5) is None


def test_idle_gaps_go_to_the_systems_spans_in_their_order_then_the_clients():
    spans = [("server.execute", 0.0, 0.5), (qlstm_server.DATAPATH, 0.1, 0.2),
             ("client.poll", 0.6, 0.8)]
    ops = [("k", 0.9, 1.0)]
    gaps = dict(TraceResult(0.0, 1.0, ops, spans,
                            datapath=qlstm_server.DATAPATH,
                            labels=qlstm_server.SPANS).idle_gaps())
    assert gaps == {"server.execute": 0.9}        # the gap's middle, 0.45
    spans.append((qlstm_server.DATAPATH, 0.4, 0.5))
    gaps = dict(TraceResult(0.0, 1.0, ops, spans,
                            labels=qlstm_server.SPANS).idle_gaps())
    assert gaps == {qlstm_server.DATAPATH: 0.9}
    gaps = dict(TraceResult(0.0, 1.0, ops, spans).idle_gaps())
    assert gaps == {"waiting": 0.9}               # no system spans named
