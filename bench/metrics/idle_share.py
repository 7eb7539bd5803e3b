"""idle_share.<cells> (device): share of the traced steps' window in which no
device activity ran, in %, from the profiler's timeline."""


def read(r):
    if r.trace is None:
        return None
    return r.trace.idle_share
