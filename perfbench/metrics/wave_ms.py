"""``wave_ms``: mean host time of one wave from dispatch to its outputs
on the host (the serving layer's ``compute_s`` over its waves) in the
measured window: the session's and engine's share of a wave."""


def read(run):
    waves = run.counters["waves"]
    if not waves:
        return None
    return 1e3 * run.counters["compute_s_total"] / waves
