"""Host-side DSP primitives (NumPy, float64).

The numerical building blocks of the float64 host chain
(``backend="numpy"``) and of the port's planners, matching the reference's
conventions (include/dsp.h):

- ``dft``/``idft`` are *unitary* scaled: ``sigpower(dft(x)) == sigpower(x)``.
- ``fshift(x, f, fs)`` multiplies by ``exp(+j*2*pi*f*t/fs)``, ``t`` from 0.
- ``tshift`` rotates a vector cyclically to the right.
- ``interpft`` resamples like MATLAB's; the wideband recordings of the
  tests and of chip_smoke.py are narrowband captures upsampled with it.
"""

from __future__ import annotations

import numpy as np
from scipy import special as _special


def dft(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Unitary-scaled DFT (reference: include/dsp.h:34)."""
    x = np.asarray(x)
    n = x.shape[axis]
    return np.fft.fft(x, axis=axis) / np.sqrt(n)


def idft(x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Unitary-scaled inverse DFT (reference: include/dsp.h:33)."""
    x = np.asarray(x)
    n = x.shape[axis]
    return np.fft.ifft(x, axis=axis) * np.sqrt(n)


def fshift(x: np.ndarray, f: float, fs: float) -> np.ndarray:
    """Shift ``x`` up in frequency by ``f`` Hz, assuming sample rate ``fs``.

    reference: include/dsp.h:40-53.
    """
    x = np.asarray(x)
    t = np.arange(x.shape[-1], dtype=np.float64)
    k = np.pi * f / (fs / 2.0)
    return x * np.exp(1j * k * t)


def tshift(x: np.ndarray, n: int) -> np.ndarray:
    """Cyclically shift ``x`` right by integer ``n`` samples.

    reference: include/dsp.h:75-97.
    """
    if n != int(n):
        raise ValueError("tshift only supports integer shifts")
    return np.roll(x, int(n), axis=-1)


def sigpower(x: np.ndarray) -> float:
    """Mean |x|^2 (reference: include/dsp.h:22-29)."""
    x = np.asarray(x)
    return float(np.mean(np.abs(x) ** 2))


def absx2(x: np.ndarray) -> np.ndarray:
    """Elementwise squared magnitude."""
    x = np.asarray(x)
    return x.real**2 + x.imag**2


def db10(x):
    return 10.0 * np.log10(x)


def db20(x):
    return 20.0 * np.log10(x)


def udb10(x):
    return np.power(10.0, np.asarray(x, dtype=np.float64) / 10.0)


def udb20(x):
    return np.power(10.0, np.asarray(x, dtype=np.float64) / 20.0)


def blnoise(n: int, rng: np.random.Generator | None = None) -> np.ndarray:
    """Unit-power complex Gaussian noise (reference: include/dsp.h:143-147)."""
    rng = rng if rng is not None else np.random.default_rng()
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2.0)


def interp1(X: np.ndarray, Y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """MATLAB-style linear interpolation with linear extrapolation.

    Unlike ``np.interp`` this extrapolates beyond the ends using the first /
    last segment slope, matching the reference (include/dsp.h:151-185), and
    supports complex ``Y``.
    """
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y)
    x = np.asarray(x, dtype=np.float64)
    if len(X) == 1:
        return np.full(x.shape, Y[0], dtype=Y.dtype)
    # Segment index for each query point: clamp so that out-of-range points
    # extrapolate with the first/last segment.
    idx = np.searchsorted(X, x, side="right") - 1
    idx = np.clip(idx, 0, len(X) - 2)
    x0 = X[idx]
    x1 = X[idx + 1]
    y0 = Y[idx]
    y1 = Y[idx + 1]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def chi2cdf_inv(p: float, k: float) -> float:
    """Inverse chi-squared CDF (reference: include/dsp.h:188-193)."""
    return 2.0 * _special.gammaincinv(k / 2.0, p)


def chi2cdf(x: float, k: float) -> float:
    return float(_special.gammainc(k / 2.0, x / 2.0))


def interpft(x: np.ndarray, n_y: int) -> np.ndarray:
    """FFT-based resampling of ``x`` to ``n_y`` points (MATLAB interpft).

    reference: src/dsp.cpp:52-91 — zero-pad in the frequency domain to an
    integer multiple of len(x) at least n_y long, inverse transform, then
    decimate.
    """
    x = np.asarray(x)
    m = len(x)
    if n_y <= 0:
        raise ValueError("n_y must be positive")
    # Upsample to n_y*incr points (incr chosen so that is >= m), then
    # decimate by incr — MATLAB's incr = floor(m/n_y) + 1.
    incr = m // n_y + 1
    n_up = n_y * incr
    X = np.fft.fft(x)
    nyqst = int(np.ceil((m + 1) / 2))
    Xp = np.concatenate([X[:nyqst], np.zeros(n_up - m, dtype=X.dtype), X[nyqst:]])
    if m % 2 == 0:
        Xp[nyqst - 1] = Xp[nyqst - 1] / 2
        Xp[nyqst - 1 + n_up - m] = Xp[nyqst - 1]
    y = np.fft.ifft(Xp) * (n_up / m)
    return y[::incr][:n_y]


def wrap(x, lower, upper):
    """Wrap scalar/array into the half-open interval [lower, upper).

    reference: include/macros.h WRAP macro.
    """
    span = upper - lower
    return np.mod(np.asarray(x) - lower, span) + lower


def matlab_mod(x, m):
    """MATLAB mod(): result has the sign of m (np.mod already does this)."""
    return np.mod(x, m)


def diff(x: np.ndarray) -> np.ndarray:
    """First difference (reference: itpp_ext.h diff / src/itpp_ext.cpp)."""
    return np.diff(np.asarray(x))


def and_reduce(x) -> bool:
    """All-true reduction over a boolean vector (itpp_ext.h and_reduce)."""
    return bool(np.all(x))


def last(x):
    """Final element (itpp_ext.h last)."""
    return np.asarray(x).reshape(-1)[-1]


def flatten(x) -> np.ndarray:
    """Flatten nested/3-D structure into a 1-D vector
    (itpp_ext.h flatten of vector<vector<cvec>>)."""
    if isinstance(x, np.ndarray):
        return x.reshape(-1)
    return np.concatenate([flatten(np.asarray(e)) for e in x])


def matlab_range(start: float, step: float, stop: float) -> np.ndarray:
    """MATLAB colon operator start:step:stop (stop inclusive, fp-safe).

    reference: include/itpp_ext.h matlab_range overloads.
    """
    if step == 0:
        raise ValueError("step must be nonzero")
    if np.sign(stop - start) * np.sign(step) < 0:
        return np.array([], dtype=np.float64)
    n = int(np.floor((stop - start) / step)) + 1
    return start + step * np.arange(n, dtype=np.float64)
