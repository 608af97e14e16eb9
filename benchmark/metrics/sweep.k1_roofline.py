"""K1's share of its roofline over the traced sweeps: the least time its
launches could take (``rooflines/xcorr_fold.py``, one launch over the
band's stack) against their kernel time in the profiler's trace."""

from benchmark.manifest import HERE, load_module


def read(win):
    if win.trace is None:
        return None
    k1 = load_module(HERE / "rooflines" / "xcorr_fold.py")
    hits = [v for k, v in win.trace.kernels.items() if k1.KERNEL in k]
    count = sum(c for c, _ in hits)
    seconds = sum(s for _, s in hits)
    if not count or not seconds:
        return None
    s = win.shapes
    return 100.0 * count * k1.bound(s["n_carriers"], s["n_hyp"],
                                    s["n_comb"], s["n_cap"]) / seconds
