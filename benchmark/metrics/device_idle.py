"""Share of the traced window's wall in which no operation ran on the
device: 100 x (1 - union of device activity / traced window). One reader
for every ``<layer>.device_idle``."""


def read(win):
    if win.trace is None or not win.trace.busy_s:
        return None
    return 100.0 * (1.0 - win.trace.busy_s / win.trace.window_s)
