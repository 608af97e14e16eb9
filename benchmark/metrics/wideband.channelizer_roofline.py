"""The wideband channelizer's share of its roofline over the traced
sweeps: the least time its convolution could take
(``rooflines/channelizer.py``, one call over the band's carriers a sweep)
against the profiler's time of the kernels the convolution launches."""

from benchmark.manifest import HERE, load_module


def read(win):
    sweeps = win.traced_units.get("sweeps", 0)
    if win.trace is None or not sweeps:
        return None
    ch = load_module(HERE / "rooflines" / "channelizer.py")
    seconds = sum(s for k, (_, s) in win.trace.kernels.items()
                  if any(name in k for name in ch.KERNELS))
    if not seconds:
        return None
    s = win.shapes
    return 100.0 * sweeps * ch.bound(s["n_wide"], s["n_cap"], s["fir_taps"],
                                     s["n_carriers"]) / seconds
