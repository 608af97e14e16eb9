"""Host milliseconds in the sample feeder's ``feed`` (tracker/producer.py;
the C++ feeder's ``feed_bytes``) per second of signal ingested: the
benchmark's span around each call, over the untraced part of the window.
The tracker keeps up with a live dongle while the layers' sum stays
under 1000."""


def read(win):
    signal_s = win.units.get("signal_s", 0.0)
    if "feeder" not in win.spans or not signal_s:
        return None
    return 1e3 * win.spans["feeder"] / signal_s
