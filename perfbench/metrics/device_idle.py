"""``device_idle``: the share of the traced sub-window in which no
operation ran on the device (one minus the union of the profiler's
device intervals over the sub-window's wall), in %.
Nothing when no device operation ran there."""


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
