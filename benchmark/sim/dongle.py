"""A site as an RTL-SDR dongle records it: one crystal clocks the tuner's
LO and the ADC, so both are off by the same fraction delta.

The site of :mod:`benchmark.sim.site` is drawn with its own offset forced
to 0 (its frame timings, SFNs and traffic come from the same seeded
stream), then sampled as the dongle samples it. A recording of ``n``
samples at 1.92 Msps lasts ``n / fs`` seconds; the dongle's clock at
``fs * (1 + delta)`` takes ``n' = n + m`` samples of it, so ``delta = m /
n``: the looping recording is resampled from ``n`` to ``n'`` samples by
exact periodic band-limited interpolation (its trigonometric series
sampled at ``t_j = j * n / n'``), and rotated by the LO's offset,
``-delta * fc``, at the dongle's rate. Over the loop the rotation makes
``-m * fc / fs`` cycles, a whole number, so the recording loops with no
jump in timing or phase.

The mix's ``site`` entry gives ``fc`` and ``slip``, ``|m|`` in samples a
recording; the seed gives m's sign. AWGN and the quantizer stay
:mod:`benchmark.sim.playback`'s. ``benchmark/reference/dongle.py`` is
the plain form that this one is held to.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from benchmark.sim import site as site_gen
from benchmark.sim.site import FS, Site


def whole_cycles(slip: int, fc: float, fs: float = FS) -> int:
    """``slip * fc / fs``, the LO's cycles over the loop; raises unless it
    is a whole number."""
    cycles = slip * fc / fs
    if abs(cycles - round(cycles)) > 1e-6:
        raise ValueError(f"a slip of {slip} samples makes {cycles} cycles "
                         f"of the LO's offset over the loop: not whole")
    return int(round(cycles))


def periodic_resample(x: np.ndarray, n_new: int) -> np.ndarray:
    """The periodic trigonometric series of ``x`` (n samples, the Nyquist
    bin of an even n split between +n/2 and -n/2) sampled at ``n_new``
    points ``t_j = j * n / n_new``: each of its bins lands on the bin of
    ``n_new`` it equals modulo ``n_new``, so the result is exact on any
    input (bins beyond ``n_new / 2`` alias, as sampling does)."""
    n = len(x)
    spec = np.fft.fft(np.asarray(x, dtype=np.complex128))
    k = np.fft.fftfreq(n, 1.0 / n).astype(np.int64)
    if n % 2 == 0:                      # fftfreq puts the Nyquist at -n/2
        spec[n // 2] *= 0.5
        spec = np.append(spec, spec[n // 2])
        k = np.append(k, n // 2)
    out = np.empty(n_new, dtype=np.complex128)
    out.real = np.bincount(k % n_new, spec.real, minlength=n_new)
    out.imag = np.bincount(k % n_new, spec.imag, minlength=n_new)
    return np.fft.ifft(out) * (n_new / n)


def dongle_clock(x: np.ndarray, slip: int, fc: float, fs: float = FS
                 ) -> Tuple[np.ndarray, float]:
    """The looping recording ``x`` (sampled at ``fs`` with an exact clock)
    as a dongle whose crystal is off by ``delta = slip / len(x)`` records
    it: (the recording of ``len(x) + slip`` samples, the LO's offset
    ``-delta * fc`` in Hz)."""
    n = len(x)
    n_new = n + slip
    cycles = whole_cycles(slip, fc, fs)
    y = periodic_resample(x, n_new)
    # The rotation's phase in whole turns, j * (-cycles) / n_new, taken
    # modulo one turn in integers: exact at every j.
    j = np.arange(n_new, dtype=np.int64)
    turns = ((-cycles * j) % n_new) / n_new
    y *= np.exp(2j * np.pi * turns)
    return y, -slip / n * fc


def crystal_slip(spec: dict, seed: int) -> int:
    """m, the samples the dongle's clock gains over a recording: ``slip``
    with a sign drawn from the seed."""
    sign = np.random.default_rng([seed, 0xD0261E]).integers(0, 2)
    return int(spec["slip"]) * (1 if sign else -1)


def draw_site(spec: dict, seed: int) -> Site:
    """The site of ``spec`` (``site.draw_site``'s keys, with
    ``max_freq_offset_hz`` ignored, plus ``fc`` and ``slip``) through the
    dongle's clock; the seed draws m's sign."""
    base = site_gen.draw_site(dict(spec, max_freq_offset_hz=0.0), seed)
    slip = crystal_slip(spec, seed)
    n = len(base.recording)
    rec, freq_offset = dongle_clock(base.recording, slip, float(spec["fc"]))
    n_new = len(rec)
    cells = [dataclasses.replace(c, timing=int(round(c.timing * n_new / n))
                                 % n_new) for c in base.cells]
    return Site(cells=cells, freq_offset=freq_offset,
                noise_power=base.noise_power, recording=rec)
