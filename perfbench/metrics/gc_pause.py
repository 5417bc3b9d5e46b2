"""``gc_pause``: the share of the measured window in which the
interpreter's garbage collector ran (every generation), in %, from the
collector's callbacks (host clock).  A full collection stops every
thread of the server and of the client alike."""


def read(run):
    busy = sum(e - s for _, s, e in run.gc_events)
    return 100.0 * busy / run.window_s
