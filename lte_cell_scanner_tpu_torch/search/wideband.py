"""Wideband cell search: one wide capture -> a whole fc sweep.

Counterpart of lte_cell_scanner_tpu/search/wideband.py. The reference
tunes the dongle to every carrier in turn and captures 80 ms each
(src/CellSearch.cpp:471-481): the sweep costs N_carriers x (tune + settle
+ capture) of radio time. A wideband SDR recording (any integer multiple
of 1.92 Msps, e.g. a 15.36 or 30.72 Msps full-band LTE capture) holds
every carrier of the band at once: this module channelizes it (a
modulated filter bank of the io/frontend.py FIR, one strided convolution
for all the carriers of a card) and hands the (B, 2, n) float32 channels,
still on the card, to the batched sweep (parallel/fc_sweep.py), so that
one 80 ms recording yields every cell in the band. Over several cards,
each card channelizes its own run of carriers from its own copy of the
recording, so that no channel crosses between cards.

The channelizer is plain PyTorch (``F.conv1d`` and elementwise products),
as the JAX package leaves it to XLA outside any Pallas kernel; it runs in
full float32 (:func:`~lte_cell_scanner_tpu_torch.utils.device.full_f32_matmuls`),
since TF32 would cost ~1e-3 relative against the 2e-4 the channels are
held to.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lte_cell_scanner_tpu_torch.io.frontend import (PASSBAND_HZ,
                                                    decimate_capture,
                                                    decimation_factor,
                                                    design_decimation_fir)
from lte_cell_scanner_tpu_torch.models.cell import Cell
from lte_cell_scanner_tpu_torch.parallel.fc_sweep import (
    _cache_put, all_cards_mesh, search_shard_stacks, shard_bounds,
    sharded_search_sweep, sweep_devices)
from lte_cell_scanner_tpu_torch.utils.device import (full_f32_matmuls,
                                                     resolve_device, upload)

CAPLENGTH = 153600   # the searcher's 80 ms analysis window
ROT_BLOCK = 2048     # S of the two-level post-rotation m = a*S + b

# (fs_in, fc_center, carriers, n_wide, n_out, device) -> Channelizer: a
# sweep's tables are built and uploaded once (6 MB on the card at 296
# carriers).
_CHANNELIZER_CACHE: dict = {}


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """What both channelizer forms derive from (fs_in, carriers, n_wide)."""

    decim: int
    h: np.ndarray        # the FIR (L,)
    phases: int          # ceil(L / decim)
    n_out: int
    n_used: int          # wide samples read: (n_out + phases - 1) * decim
    fs_int: int
    sh_int: List[int]    # integer-Hz shifts carrier - center


def _geometry(fs_in, fc_center, fc_list, n_wide, n_out) -> _Geometry:
    decim = decimation_factor(fs_in)
    h = design_decimation_fir(decim)
    phases = -(-len(h) // decim)
    avail = n_wide // decim - phases + 1
    if n_out is None:
        n_out = min(CAPLENGTH, avail)
    if not 1 <= n_out <= avail:
        raise ValueError(f"wide capture too short: {n_wide} samples give "
                         f"{avail} outputs at decim={decim}, want {n_out}")
    # Integer-Hz shifts (< 1 Hz rounding, far below the 5 kHz hypothesis
    # grid); all angle math stays in host float64 with exact integer mods.
    return _Geometry(decim, h, phases, n_out, (n_out + phases - 1) * decim,
                     int(round(fs_in)),
                     [int(round(fc - fc_center)) for fc in fc_list])


def _mod_products(sh: List[int], idx: np.ndarray, fs_int: int) -> np.ndarray:
    """(sh[:, None] * idx[None]) % fs_int as float64. The int64 products
    are exact: |shift| < 2^31 Hz times a sample index < 2^31."""
    m = (np.asarray(sh, np.int64)[:, None] * idx[None]) % fs_int
    return m.astype(np.float64)


def channelizer_tables(g: _Geometry):
    """The filter bank's host tables, float32: the conv kernel (2B, 2, L)
    and the post-rotation tables t1 (B, n_a, 2), t2 (B, S, 2).

    For carrier c with downshift w_c = 2 pi shift_c / fs, the host path
    computes y_c[m] = sum_k h[k] e^{-j w_c t} x[t], t = m decim + L-1-k,
    which factors into a carrier-modulated filter and a decimated-rate
    post-rotation:
        y_c[m] = e^{-j w_c (m decim + L-1)}
                 sum_{k'} (h[L-1-k'] e^{j w_c (L-1-k')}) x[m decim + k'].
    Kernel rows 2c and 2c+1 give the real and imaginary parts of the sum
    from the (re, im) input planes. The rotation splits m = a S + b into
    t1[c, a] = e^{-j w_c (a S decim + L-1)} and t2[c, b] = e^{-j w_c b
    decim}; every angle is an exact integer mod in float64, one float32
    rounding per factor, and no periodicity of the carrier grid is
    assumed.
    """
    B, L, S = len(g.sh_int), len(g.h), ROT_BLOCK
    sh = g.sh_int
    k = np.arange(L, dtype=np.int64)
    ang = 2.0 * np.pi * _mod_products(sh, L - 1 - k, g.fs_int) / g.fs_int
    kr = g.h[::-1] * np.cos(ang)
    ki = g.h[::-1] * np.sin(ang)
    kern = np.zeros((2 * B, 2, L), np.float32)
    kern[0::2, 0], kern[0::2, 1] = kr, -ki
    kern[1::2, 0], kern[1::2, 1] = ki, kr
    n_a = -(-g.n_out // S)
    a = np.arange(n_a, dtype=np.int64)
    b = np.arange(S, dtype=np.int64)
    ang1 = -2.0 * np.pi * _mod_products(sh, a * S * g.decim + L - 1,
                                        g.fs_int) / g.fs_int
    ang2 = -2.0 * np.pi * _mod_products(sh, b * g.decim, g.fs_int) / g.fs_int
    t1 = np.stack([np.cos(ang1), np.sin(ang1)], -1).astype(np.float32)
    t2 = np.stack([np.cos(ang2), np.sin(ang2)], -1).astype(np.float32)
    return kern, t1, t2


class Channelizer:
    """The one-pass channelizer of B carriers on one device.

    ``ch(planes)`` maps the (2, >= n_used) float32 wide planes (re, im) on
    the channelizer's device to the contiguous (B, 2, n_out) float32
    channels at 1.92 Msps: one strided real convolution of the planes with
    the modulated kernel (stride decim; the FIR work of every carrier in
    one product of (n_out, 2 L) windows by (2 L, 2 B) taps), then the two
    broadcast complex products of the post-rotation. The same math as
    io/frontend.decimate_capture per carrier (parity <= 2e-4 x max).
    """

    def __init__(self, g: _Geometry, dev: torch.device):
        self.decim, self.n_out, self.n_used = g.decim, g.n_out, g.n_used
        self.n_carriers = len(g.sh_int)
        kern, t1, t2 = channelizer_tables(g)
        self.kern, self.t1, self.t2 = (upload(kern, dev), upload(t1, dev),
                                       upload(t2, dev))
        self.device = self.kern.device     # with its index

    def __call__(self, planes: torch.Tensor) -> torch.Tensor:
        if (planes.dtype != torch.float32 or planes.dim() != 2
                or planes.shape[0] != 2 or planes.shape[1] < self.n_used
                or planes.device != self.device):
            raise ValueError(
                f"want (2, >= {self.n_used}) float32 planes on "
                f"{self.device}, got {tuple(planes.shape)} {planes.dtype} "
                f"on {planes.device}")
        full_f32_matmuls()
        B, n_out, S = self.n_carriers, self.n_out, ROT_BLOCK
        y = F.conv1d(planes[None, :, :self.n_used], self.kern,
                     stride=self.decim)[0, :, :n_out].view(B, 2, n_out)
        n_a = -(-n_out // S)
        if n_a * S != n_out:
            y = F.pad(y, (0, n_a * S - n_out))
        y = y.view(B, 2, n_a, S)
        re, im = y[:, 0], y[:, 1]                            # (B, n_a, S)
        c2, s2 = self.t2[:, None, :, 0], self.t2[:, None, :, 1]
        c1, s1 = self.t1[:, :, None, 0], self.t1[:, :, None, 1]
        yr = re * c2 - im * s2
        yi = re * s2 + im * c2
        out = torch.empty((B, 2, n_a, S), dtype=torch.float32,
                          device=self.device)
        torch.sub(yr * c1, yi * s1, out=out[:, 0])
        torch.add(yr * s1, yi * c1, out=out[:, 1])
        out = out.view(B, 2, n_a * S)
        return out if n_a * S == n_out else out[:, :, :n_out].contiguous()


def make_channelizer(fs_in: float, fc_center: float,
                     fc_list: Sequence[float], n_wide: int,
                     n_out: int = None, device=None) -> Channelizer:
    """The one-pass channelizer of ``fc_list`` out of an ``n_wide``-sample
    recording at ``fs_in`` centred at ``fc_center`` (``n_out`` default:
    80 ms, or what the recording holds). Its tables stay on ``device``
    (``None``: the CUDA card, raising without one) in a bounded cache."""
    dev = resolve_device(device)
    key = (float(fs_in), float(fc_center), tuple(map(float, fc_list)),
           int(n_wide), n_out, str(dev))
    ch = _CHANNELIZER_CACHE.get(key)
    if ch is None:
        ch = Channelizer(_geometry(fs_in, fc_center, fc_list, n_wide, n_out),
                         dev)
        _cache_put(_CHANNELIZER_CACHE, key, ch)
    return ch


def wide_planes(wide: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A complex recording as (2, n) float32 planes on ``dev``."""
    wide = np.asarray(wide)
    planes = np.empty((2, len(wide)), np.float32)
    planes[0], planes[1] = wide.real, wide.imag
    return upload(planes, dev)


def channelize_batch(wide: np.ndarray, fs_in: float, fc_center: float,
                     fc_list: Sequence[float], n_out: int = None,
                     device=None) -> torch.Tensor:
    """Channelize every carrier of ``fc_list`` out of the complex
    recording ``wide`` in one pass (:class:`Channelizer`). Returns the
    (B, 2, n_out) float32 channels on ``device`` (``None``: the CUDA card;
    ``"cpu"``: plain PyTorch on the host), ready for the batched sweep."""
    ch = make_channelizer(fs_in, fc_center, fc_list, len(wide), n_out,
                          device)
    return ch(wide_planes(wide, ch.device))


class ChannelizerMap:
    """The per-carrier baseline of :class:`Channelizer` (the JAX package's
    lax.map form), for benchmarking (tools/bench_wideband.py) and as an
    independent cross-check of the filter bank; its time grows linearly
    with the carriers. Per carrier: the downshift at full rate, then the
    polyphase products of io/frontend.decimate_capture.

    The downshift's angle is the exact integer phase (shift x t) mod fs,
    rounded once to float32 and scaled by -2 pi / fs: under 5e-7 rad. The
    JAX form wraps t mod fs / gcd(shift, fs) and takes the float32 product
    (-2 pi rate) x (t mod period), whose angles reach thousands of radians
    at a 30.72 Msps recording's outer carriers (period 1,536 at -12.1 MHz)
    and lose up to 2.4e-4 rad to float32 rounding, more than the 2e-4 the
    channels are held to (ROADMAP.md, section 3)."""

    def __init__(self, g: _Geometry, dev: torch.device):
        self.decim, self.n_out, self.n_used = g.decim, g.n_out, g.n_used
        taps = g.h[::-1].copy()
        taps = np.pad(taps, (0, g.phases * g.decim - len(taps)))
        self.taps = upload(taps.reshape(g.phases, g.decim)
                           .astype(np.float32), dev)
        self.device = self.taps.device
        self.sh_int, self.fs_int = g.sh_int, g.fs_int

    def __call__(self, planes: torch.Tensor) -> torch.Tensor:
        full_f32_matmuls()
        n_used, n_out = self.n_used, self.n_out
        pl = planes[:, :n_used]
        t = torch.arange(n_used, device=self.device)
        scale = -2.0 * np.pi / self.fs_int
        out = []
        for sh in self.sh_int:
            ang = torch.remainder(t * sh, self.fs_int).to(torch.float32) \
                * scale
            c, s = torch.cos(ang), torch.sin(ang)
            xb = torch.stack([pl[0] * c - pl[1] * s,
                              pl[0] * s + pl[1] * c]).view(2, -1, self.decim)
            acc = torch.zeros((2, n_out), dtype=torch.float32,
                              device=self.device)
            for q in range(self.taps.shape[0]):
                acc += xb[:, q:q + n_out] @ self.taps[q]
            out.append(acc)
        return torch.stack(out)


def make_channelizer_map(fs_in: float, fc_center: float,
                         fc_list: Sequence[float], n_wide: int,
                         n_out: int = None, device=None) -> ChannelizerMap:
    """The per-carrier channelizer (same contract as
    :func:`make_channelizer`, not cached)."""
    return ChannelizerMap(_geometry(fs_in, fc_center, fc_list, n_wide,
                                    n_out), resolve_device(device))


def channelize_batch_map(wide: np.ndarray, fs_in: float, fc_center: float,
                         fc_list: Sequence[float], n_out: int = None,
                         device=None) -> torch.Tensor:
    """:func:`channelize_batch` in the per-carrier form."""
    ch = make_channelizer_map(fs_in, fc_center, fc_list, len(wide), n_out,
                              device)
    return ch(wide_planes(wide, ch.device))


def wideband_carriers(fs_in: float, fc_center: float,
                      freq_start: float, freq_end: float,
                      raster: float = 100e3) -> List[float]:
    """The 100 kHz-raster carriers inside [freq_start, freq_end] whose
    600 kHz occupancy fits the recording's usable bandwidth."""
    usable = fs_in / 2.0 - PASSBAND_HZ
    lo = max(freq_start, fc_center - usable)
    hi = min(freq_end, fc_center + usable)
    first = np.ceil(lo / raster) * raster
    return [float(f) for f in np.arange(first, hi + raster / 2, raster)]


def wideband_search_sweep(wide: np.ndarray, fs_in: float,
                          fc_center: float, fc_list: Sequence[float],
                          f_search_set: np.ndarray, device=None,
                          backend: str = "torch", **sweep_kw
                          ) -> Tuple[List[List[Cell]], List[Cell]]:
    """Channelize ``wide`` (complex, fs_in Sps, centred at fc_center) at
    every carrier of ``fc_list`` and run the batched search sweep
    (:func:`~lte_cell_scanner_tpu_torch.parallel.fc_sweep.sharded_search_sweep`,
    ``sweep_kw``) on the 1.92 Msps channels, on ``device``: ``None`` spans
    every visible card the carriers divide over (the largest such count,
    :func:`~lte_cell_scanner_tpu_torch.parallel.fc_sweep.all_cards_mesh`)
    and raises without CUDA; a CapMesh, its shards; ``"cpu"``, the plain
    versions. One host thread dispatches every shard, so on several cards
    ``device="cuda:0"`` (one card) is expected to be faster until scaling
    across cards is measured (PERF.md).

    ``backend="torch"`` channelizes on each shard's device only that
    shard's run of carriers, from its own upload of the recording, and
    the channels stay there through the sweep; ``backend="numpy"`` is the
    float64 per-carrier host reference (io/frontend.decimate_capture),
    whose captures are then uploaded. Returns (cells_per_carrier,
    deduped) like sharded_search_sweep.
    """
    if device is None:
        device = all_cards_mesh(len(fc_list))
    if backend == "torch":
        devs = sweep_devices(None, device)
        caps = [channelize_batch(wide, fs_in, fc_center, fc_list[lo:hi],
                                 device=dev)
                for dev, (lo, hi) in zip(devs, shard_bounds(len(fc_list),
                                                            len(devs)))]
        return search_shard_stacks(caps, list(fc_list),
                                   np.asarray(f_search_set), **sweep_kw)
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")
    caps = [decimate_capture(wide, fs_in, freq_shift=fc - fc_center)
            [:CAPLENGTH] for fc in fc_list]
    n = min(len(c) for c in caps)
    return sharded_search_sweep(np.stack([c[:n] for c in caps]),
                                list(fc_list), np.asarray(f_search_set),
                                device=device, **sweep_kw)
