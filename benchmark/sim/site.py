"""A site of LTE cells on one carrier, and the dongle's captures of it.

Every cell of a site shares the carrier, its bandwidth and one frequency
offset (the dongle's crystal is common to all of them); each has its own
PCI, power, frame timing and SFN. A traffic file fixes the PCIs, the
powers, the SNR of the strongest cell and the recording's length; the
seed draws the frame timings, the SFNs, the offset, the traffic on the
free resource elements and all noise. Every seed gives the same amount
of work.

The noiseless recording lasts a whole number of 40 ms PBCH periods and
the offset makes a whole number of cycles over it, so a recording that
loops has no phase jump; each cell is rotated in time by its frame timing
(np.roll), so its frames stay whole across the loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from benchmark.sim.raw import bytes_to_iq, iq_to_bytes
from benchmark.sim.simulator import MibConfig, create_dl_sig

FS = 1.92e6
FRAME = 19200
HALF_FRAME = 9600


@dataclasses.dataclass
class SiteCell:
    pci: int
    power_db: float      # relative to the strongest cell
    timing: int          # samples from the recording's start to a frame
    sfn_start: int
    n_rb_dl: int
    phich_duration: str
    phich_resource: float


@dataclasses.dataclass
class Site:
    cells: List[SiteCell]
    freq_offset: float   # Hz, common to every cell
    noise_power: float   # AWGN power per complex sample
    recording: np.ndarray  # noiseless complex128, looping


def draw_site(spec: dict, seed: int) -> Site:
    """Build a site from a traffic file's ``site`` entry and a seed.

    ``spec``: ``cells`` (list of {pci, power_db}), ``snr_db`` of the
    strongest cell, ``amplitude`` (RMS of the strongest cell, full scale
    1), ``recording_ms`` (a multiple of 40), ``load_factor``,
    ``max_freq_offset_hz``, and the MIB of the carrier (``n_rb_dl``,
    ``phich_duration``, ``phich_resource``).
    """
    rng = np.random.default_rng([seed, 0x5173])
    n_ms = int(spec["recording_ms"])
    if n_ms % 40:
        raise ValueError("recording_ms must be a whole number of 40 ms "
                         "PBCH periods")
    n = n_ms * 1920
    # One offset for the site, a whole number of cycles over the recording.
    step = FS / n
    k_max = int(spec["max_freq_offset_hz"] // step)
    freq_offset = float(rng.integers(-k_max, k_max + 1)) * step
    # Frame timings: distinct positions within the half frame (2,400
    # samples apart, jittered), then a random half; SFNs at random.
    specs = spec["cells"]
    base = int(rng.integers(0, HALF_FRAME))
    jitter = rng.integers(0, HALF_FRAME // len(specs) // 4, len(specs))
    halves = rng.integers(0, 2, len(specs))
    sfns = rng.integers(0, 1024, len(specs))
    cells = []
    for i, c in enumerate(specs):
        timing = (base + i * (HALF_FRAME // len(specs)) + int(jitter[i])
                  + HALF_FRAME * int(halves[i])) % FRAME
        cells.append(SiteCell(
            pci=int(c["pci"]), power_db=float(c["power_db"]), timing=timing,
            sfn_start=int(sfns[i]), n_rb_dl=int(spec["n_rb_dl"]),
            phich_duration=spec["phich_duration"],
            phich_resource=float(spec["phich_resource"])))
    amp = float(spec["amplitude"])
    sig = np.zeros(n, dtype=np.complex128)
    for c in cells:
        mib = MibConfig(n_rb_dl=c.n_rb_dl, phich_duration=c.phich_duration,
                        phich_resource=c.phich_resource,
                        sfn_start=c.sfn_start)
        tx = create_dl_sig("normal", n_ms, 0, c.pci // 3, c.pci % 3,
                           float(spec["load_factor"]), rng, mib=mib)
        nz = np.abs(tx) > 0
        tx = tx / np.sqrt(np.mean(np.abs(tx[nz]) ** 2))
        sig += np.roll(tx, c.timing) * amp * 10 ** (c.power_db / 20)
    sig *= np.exp(2j * np.pi * freq_offset * np.arange(n) / FS)
    noise_power = amp ** 2 / 10 ** (float(spec["snr_db"]) / 10)
    return Site(cells=cells, freq_offset=freq_offset,
                noise_power=noise_power, recording=sig)


def quantize(iq: np.ndarray) -> np.ndarray:
    """The dongle's samples as the capture path reads them: the rtl_sdr
    uint8 quantizer (``iq_to_bytes``) and back (``bytes_to_iq``), over
    the last axis, for any leading shape."""
    lead = iq.shape[:-1]
    flat = bytes_to_iq(iq_to_bytes(iq.reshape(-1)))
    return flat.reshape(*lead, iq.shape[-1])


def _levels(x: np.ndarray) -> np.ndarray:
    """``bytes_to_iq(iq_to_bytes(.))`` of one real plane, in place: the
    same float64 operations without the interleaved bytes."""
    x *= 128.0
    x += 127.0
    np.round(x, out=x)
    np.clip(x, 0, 255, out=x)
    x -= 127.0
    x /= 128.0
    return x


def band_recording(n_carriers: int, occupied: Sequence[int], site: Site,
                   caplength: int, seed: int, index: int) -> np.ndarray:
    """One sweep's captures, (n_carriers, caplength) complex128: every
    carrier holds the dongle's noise, and each carrier in ``occupied``
    also 80 ms of the site from a random position of its recording."""
    rng = np.random.default_rng([seed, 0xBA4D, index])
    scale = np.sqrt(site.noise_power / 2)
    planes = []
    for part in (0, 1):
        x = rng.standard_normal((n_carriers, caplength), dtype=np.float32)
        planes.append(x.astype(np.float64) * scale)
    n = len(site.recording)
    for b in occupied:
        start = int(rng.integers(0, n))
        iq = site.recording[(start + np.arange(caplength)) % n]
        planes[0][b] += iq.real
        planes[1][b] += iq.imag
    out = np.empty((n_carriers, caplength), dtype=np.complex128)
    out.real = _levels(planes[0])
    out.imag = _levels(planes[1])
    return out
