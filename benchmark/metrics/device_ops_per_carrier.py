"""Device operations (kernels, copies, sets) per carrier searched while
the profiler ran: a sweep's stack or ``cell_search``'s one capture. The
launches are the host's cost; fewer move the cell's rate or latency. One
reader for every ``<layer>.device_ops_per_carrier``."""


def read(win):
    n = win.traced_units.get("carriers", 0)
    if win.trace is None or not n or not win.trace.n_device_ops:
        return None
    return win.trace.n_device_ops / n
