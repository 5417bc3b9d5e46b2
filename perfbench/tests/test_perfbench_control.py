"""The comparison's control: the reference in the program's place at a
step lower precision fails the comparison (at a test's size; on the card
``perfbench/control.py`` reads it at each cell's own size)."""

import pytest

from perfbench import compare
from perfbench.control import readings


@pytest.mark.parametrize("workload,mix", [
    ("pems-steady", {"rate_per_s": 4000.0}),
    ("pems-steady", {"rate_per_s": 2000.0, "streams": 40}),
    ("pems-cluster4", {"rate_per_s": 4000.0})])
def test_control_is_not_correct(workload, mix):
    got = readings(workload, 2 ** 31 + 7, 0.05, mix_overrides=mix)
    assert got["windows"] > 50
    assert got["mismatched"] > compare.LIMITS["mismatched"]
    assert got["max_code_gap"] > compare.LIMITS["max_code_gap"]
