"""A traced sub-window is read only where it is whole: for a system that
names its datapath span, every such span overlaps a device operation,
and the spans saw the waves the server counted; for a system with no
spans, device operations were seen where requests were answered; and
for a system that names the kernel each datapath call launches, the
trace holds one launch of it a datapath span, whichever thread made
the call."""

import pytest

from perfbench.systems import qlstm_server
from perfbench.trace import TraceResult, host_clock


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


def _cluster_trace(k3_at, others=()):
    """Four threads' datapath spans overlapping in turn, as a cluster's
    replicas' do, K3 launches at ``k3_at`` and other device operations
    at ``others``."""
    paths = [(0.10, 0.13), (0.12, 0.15), (0.14, 0.17), (0.16, 0.19)]
    spans = [(qlstm_server.DATAPATH, s, e) for s, e in paths]
    ops = [(K3, t, t + 1e-5) for t in k3_at]
    ops += [("Memcpy DtoD (Device -> Device)", t, t + 1e-5) for t in others]
    return TraceResult(0.0, 1.0, ops, spans, datapath=qlstm_server.DATAPATH,
                       labels=qlstm_server.SPANS,
                       kernel=qlstm_server.WAVE_KERNEL)


K3 = "void qlstm_rows_kernel<signed char, true>(QlstmArgs)"


def test_a_trace_that_lost_another_threads_kernels_is_refused():
    """Every span holds a launch, because the threads' spans overlap, yet
    two of the four calls' launches are missing: the count refuses the
    trace, the overlap alone would not."""
    whole = _cluster_trace([0.11, 0.13, 0.15, 0.17])
    assert whole.fault(4) is None
    lost = _cluster_trace([0.125, 0.165])
    assert "the sub-window 2 launches" in lost.fault(4)
    lost.kernel = None
    assert lost.fault(4) is None


def test_a_trace_misplaced_on_the_host_clock_is_refused():
    """Every launch shifted 300 ms late against the spans, as a skewed
    mapping of the two clocks leaves them: the spans still overlap other
    operations, but none holds the start of a launch."""
    shifted = _cluster_trace([0.41, 0.43, 0.45, 0.47],
                             others=[0.105, 0.125, 0.145, 0.165, 0.185])
    assert "4 of 4 datapath spans" in shifted.fault(4)
    shifted.kernel = None
    assert shifted.fault(4) is None


def test_the_clocks_are_matched_at_the_tightest_marks():
    """A mark whose bracket on the host clock is wide (the client waited
    for the interpreter before it stamped it) is passed over for the
    tightest one at the same end."""
    # Trace microseconds: the truth is host = 10 s + us * 1e-6.
    marks = [(0.0, 2.0), (100.0, 102.0), (1e6, 1e6 + 2.0)]
    opening = [(9.999, 10.004), (10.0001, 10.0001 + 2e-6)]
    closing = [(11.0, 11.0 + 2e-6)]
    to_host = host_clock(marks, opening, closing)
    assert abs(to_host(5e5) - 10.5) < 1e-6
    assert abs(to_host(100.0) - 10.0001) < 1e-6
    with pytest.raises(RuntimeError, match="2 of the client's 3"):
        host_clock(marks[:2], opening, closing)
