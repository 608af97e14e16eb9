"""A wideband SDR's recording of several sites: the US 700 MHz downlink in
one sc16 file, as a surveyor's USRP B210 or bladeRF records it at 30.72
Msps (UHD's ``rx_samples_to_file --type short``).

Each occupied carrier holds a site of :mod:`benchmark.sim.site` (its
cells, powers, one frequency offset, frame timings and SFNs drawn from the
seed), as a noiseless 1.92 Msps loop of a whole number of 40 ms PBCH
periods. The loop is upsampled by exact FFT zero-padding (the generator's
own interpolation, independent of any FIR of the program), read
cyclically from its start for the recording's length (the loop has no
seam: whole frames, whole cycles of the offset), and shifted to its
carrier by the exact integer phase ((shift t) mod fs) / fs. The sites are
summed, complex AWGN is added at the density that gives every serving
cell its ``snr_db`` inside a 1.92 Msps channel, and the sum is scaled so
that its largest I or Q value sits at a share of full scale, rounded and
stored as interleaved int16.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from benchmark.sim.site import FS, Site, draw_site

SC16_FULL_SCALE = 32768


def upsample(loop: np.ndarray, factor: int) -> np.ndarray:
    """A periodic complex signal of even length interpolated ``factor``
    times by FFT zero-padding (as MATLAB's interpft: the Nyquist bin split
    between the two edges), one period long."""
    n = len(loop)
    if n % 2:
        raise ValueError(f"want an even length, got {n}")
    half = n // 2
    spec = np.fft.fft(loop)
    out = np.zeros(n * factor, dtype=np.complex128)
    out[:half] = spec[:half]
    out[-(half - 1):] = spec[half + 1:]
    out[half] = out[-half] = spec[half] / 2
    return np.fft.ifft(out) * factor


def draw_sites(sites: Sequence[dict], common: dict, seed: int,
               index: int) -> List[Tuple[float, Site]]:
    """(carrier Hz, Site) of each entry of ``sites`` ({fc, cells,
    n_rb_dl}) for the pool's recording ``index``: the same cells and
    powers in every recording, offsets, timings and SFNs drawn anew."""
    out = []
    for j, s in enumerate(sites):
        spec = dict(common, cells=s["cells"], n_rb_dl=int(s["n_rb_dl"]))
        out.append((float(s["fc"]),
                    draw_site(spec, (int(seed) << 12) | (index << 6) | j)))
    return out


def wide_recording(sites: Sequence[Tuple[float, Site]], fs_in: float,
                   fc_center: float, n_wide: int, seed: int, index: int,
                   full_scale_share: float) -> np.ndarray:
    """One recording, (n_wide, 2) int16: every site on its carrier, the
    AWGN, the scale; see the module docstring."""
    decim = int(round(fs_in / FS))
    fs_int = int(round(fs_in))
    t = np.arange(n_wide, dtype=np.int64)
    total = np.zeros(n_wide, dtype=np.complex128)
    for fc, site in sites:
        wide = upsample(site.recording, decim)
        wide = wide[t % len(wide)]
        phase = (t * int(round(fc - fc_center))) % fs_int
        total += wide * np.exp(2j * np.pi * phase / fs_int)
    # Noise density: each site's noise_power is per 1.92 Msps sample; a
    # 1.92 MHz channel holds 1 / decim of the wide band's.
    noise_power = decim * max(site.noise_power for _, site in sites)
    rng = np.random.default_rng([seed, 0x3D1D, index])
    scale = np.sqrt(noise_power / 2)
    total.real += rng.standard_normal(n_wide) * scale
    total.imag += rng.standard_normal(n_wide) * scale
    peak = max(np.abs(total.real).max(), np.abs(total.imag).max())
    total *= full_scale_share * SC16_FULL_SCALE / peak
    out = np.empty((n_wide, 2), dtype=np.int16)
    out[:, 0] = np.round(total.real)
    out[:, 1] = np.round(total.imag)
    return out
