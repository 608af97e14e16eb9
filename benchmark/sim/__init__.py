"""The benchmark's signal generator: a frozen copy of the port's eNodeB
simulator (``io/simulator.py``), its uint8 quantizer (``io/raw.py``) and
the tracker's file playback (``tracker/runtime.py::playback_source``),
plus :mod:`benchmark.sim.site`, which builds a multi-cell site and the
dongle's noise from a traffic file's parameters and a seed. Later changes
to the program cannot move what the benchmark feeds it."""
