"""``setup_s``: seconds from the harness's start to the measured window's
opening: imports, the kernel build or load, the session built from the
seed, the server with its state table, the warm waves and the traffic's
windows (host clock)."""


def read(run):
    return run.setup_s
