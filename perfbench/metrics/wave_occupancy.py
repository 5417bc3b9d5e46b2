"""``wave_occupancy``: real windows over the wave slots computed
(``samples / (waves * batch)``) in the measured window, from the
serving layer's lifetime counters (``serving/metrics.py::MetricsSink``),
in %."""


def read(run):
    waves = run.counters["waves"]
    if not waves:
        return None
    return 100.0 * run.counters["samples"] / (waves * run.batch)
