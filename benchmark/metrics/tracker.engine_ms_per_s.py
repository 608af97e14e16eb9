"""Host milliseconds in the engine's ``process_all``
(tracker/batch_runtime.py) per second of signal ingested: the
benchmark's span around each call, over the untraced part of the window.
The tracker keeps up with a live dongle while the layers' sum stays
under 1000."""


def read(win):
    signal_s = win.units.get("signal_s", 0.0)
    if "engine" not in win.spans or not signal_s:
        return None
    return 1e3 * win.spans["engine"] / signal_s
