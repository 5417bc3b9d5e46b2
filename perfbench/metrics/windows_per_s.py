"""``windows_per_s``: windows answered a second: the windows whose result
was polled, without error, inside the measured window, over the window's
length (host clock).  Below the server's capacity it reads the offered
rate less the windows still in flight at the close; it falls when the
server falls behind the arrivals."""


def read(run):
    n = run.done_between(run.t0, run.t1)
    return n / run.window_s if n else None
