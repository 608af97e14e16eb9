"""One carrier of a wideband recording, channelized from the definition in
float64: the plain reference of the wideband search's 1.92 Msps channels.

Kept in two equal copies, ``benchmark/reference/channelize.py`` (the
benchmark's reference) and ``tests/plain_wideband.py`` (the test suite's);
it imports neither JAX nor anything of the program. Plain PyTorch on the
CPU, float64 and complex128 throughout, TF32 off:

1. the sc16 samples (interleaved int16 I/Q) become complex128, x / 32768;
2. the carrier is shifted to 0 Hz by the exact integer phase: sample t is
   multiplied by exp(-2j pi ((shift t) mod fs) / fs), shift = fc -
   fc_center and fs in whole Hz;
3. the decimation FIR is designed here from its documented spec (the
   front end's, io/frontend.py): a Kaiser-windowed sinc with a 600 kHz
   passband (6 RB x 12 x 15 kHz / 2 + 4 x 15 kHz, the searcher's
   occupancy), the stopband at 1.92 MHz - 600 kHz (the first alias onto
   the passband edge), 60 dB of stopband rejection (Kaiser's beta and
   length formulas), the length rounded up to 2 decim k + 1, unit gain at
   0 Hz;
4. decimation by fs / 1.92 Msps, output m aligned as
   io/frontend.py::decimate_capture documents: y[m] = sum_k h[k] x[m
   decim + L - 1 - k], m from 0.

While ``benchmark/control.py`` computes the reference in TF32 (it swaps
the name ``np`` of every reference module for its rounding numpy), every
operand of a product here (the samples, the phase factors, the shifted
samples and the taps) is first rounded to TF32 (10 mantissa bits, ties
away from zero, as ``cvt.rna.tf32.f32``): the nearest precision below
the program's float32.
"""

from __future__ import annotations

import math

import numpy
import torch

np = numpy       # benchmark/control.py swaps this name (see above)

FS_SEARCH = 1.92e6
PASSBAND_HZ = 6 * 12 * 15e3 / 2 + 4 * 15e3
STOP_ATTEN_DB = 60.0
N_OUT = 153600          # the searcher's 80 ms capture
SC16_FULL_SCALE = 32768.0


def decimation_fir(decim: int) -> torch.Tensor:
    """The FIR's float64 taps (L,) for decimation by ``decim``."""
    fs_in = decim * FS_SEARCH
    f_pass, f_stop = PASSBAND_HZ, FS_SEARCH - PASSBAND_HZ
    df = (f_stop - f_pass) / fs_in
    beta = 0.1102 * (STOP_ATTEN_DB - 8.7)         # Kaiser, above 50 dB
    n = math.ceil((STOP_ATTEN_DB - 7.95) / (2.285 * 2 * math.pi * df))
    n = (n // (2 * decim) + 1) * 2 * decim + 1
    k = torch.arange(n, dtype=torch.float64) - (n - 1) / 2
    fc = (f_pass + f_stop) / 2 / fs_in
    h = (2 * fc * torch.sinc(2 * fc * k)
         * torch.kaiser_window(n, periodic=False, beta=beta,
                               dtype=torch.float64))
    return h / h.sum()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (through float32), back in its own dtype."""
    if x.is_complex():
        return torch.complex(tf32_round(x.real), tf32_round(x.imag))
    bits = x.to(torch.float32).view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32).to(x.dtype)


def channelize(sc16: numpy.ndarray, fs_in: float, fc_center: float,
               fc: float, n_out: int = N_OUT) -> numpy.ndarray:
    """The (n_out,) complex128 channel at ``fc`` of the sc16 recording
    ``sc16`` ((n, 2) int16, ``fs_in`` Sps centred at ``fc_center``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rnd = tf32_round if np is not numpy else (lambda v: v)
    decim = int(round(fs_in / FS_SEARCH))
    if abs(fs_in / FS_SEARCH - decim) > 1e-9:
        raise ValueError(f"fs_in={fs_in} is not a multiple of 1.92 Msps")
    h = rnd(decimation_fir(decim))
    n_used = (n_out - 1) * decim + len(h)
    if len(sc16) < n_used:
        raise ValueError(f"recording too short: {len(sc16)} samples, want "
                         f"{n_used}")
    iq = torch.from_numpy(numpy.asarray(sc16[:n_used], dtype=numpy.float64))
    x = rnd(torch.complex(iq[:, 0], iq[:, 1]) / SC16_FULL_SCALE)
    fs_int, shift = int(round(fs_in)), int(round(fc - fc_center))
    phase = torch.remainder(torch.arange(n_used, dtype=torch.int64) * shift,
                            fs_int).to(torch.float64)
    rot = rnd(torch.exp(torch.complex(torch.zeros_like(phase),
                                      -2 * math.pi * phase / fs_int)))
    x = rnd(x * rot)
    y = torch.zeros(n_out, dtype=torch.complex128)
    span = (n_out - 1) * decim + 1
    for k in range(len(h)):
        start = len(h) - 1 - k
        y += h[k] * x[start:start + span:decim]
    return y.numpy()
