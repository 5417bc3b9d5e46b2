"""The operation and byte counts the benchmark's metrics rest on."""

from perfbench import counts

from repro_torch.core.qlstm import QLSTMConfig, ops_per_inference


def test_ops_per_window_is_the_papers_count():
    assert counts.ops_per_window(1, 20, 1, 6, 1) == 22001
    for m, h, layers, t, p in [(1, 20, 1, 6, 1), (3, 16, 2, 8, 2)]:
        cfg = QLSTMConfig(input_size=m, hidden_size=h, num_layers=layers,
                          seq_len=t, out_features=p)
        assert counts.ops_per_window(m, h, layers, t, p) == \
            ops_per_inference(cfg)


def test_k3_count_reproduces_the_kernel_tables_bound():
    """The repository's kernel table gives K3 at B=64 against a (1026, 1,
    2, 20) table a bound of 0.000101 ms by bytes.  That count read and
    wrote the whole table; with the table's 1,026 rows it is reproduced.
    The benchmark counts the wave's 64 rows instead: the kernel gathers
    and scatters only those (the wrapper's copy of the table is a
    separate device operation).  Its bytes are a tenth, and the bound is
    then the operations at the CUDA cores' rate, about a fifth."""
    whole = counts.k3_bytes(1, 20, 1, 6, 8, 64, table_rows=1026)
    assert whole == 338896
    assert round(counts.bound_s(whole, 21960 * 64) * 1e3, 6) == 0.000101
    wave = counts.k3_bytes(1, 20, 1, 6, 8, 64)
    assert wave == 384 + 2000 + 512 + 2 * 64 * 160 + 6 * 64 * 20
    assert wave < 0.1 * whole
    assert counts.bound_s(wave, 21960 * 64) == 21960 * 64 / 67e12


def test_bound_takes_the_slower_of_bytes_and_operations():
    b = counts.k3_bytes(1, 20, 1, 6, 8, 256)
    ops = counts.lstm_ops(1, 20, 1, 6) * 256
    assert counts.bound_s(b, ops) == max(b / 3.35e12, ops / 67e12)
