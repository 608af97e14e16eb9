"""K1's share of its roofline over the traced wideband sweeps: the reader
of ``sweep.k1_roofline`` (``rooflines/xcorr_fold.py``, one launch over
the stack) at this cell's shapes, one launch over the band's channels."""

from benchmark.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "sweep.k1_roofline.py").read
