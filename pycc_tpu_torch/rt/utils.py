"""Spectral post-processing for RT-CC time series (host numpy/scipy).

The port's own copy of pycc_tpu/rt/utils.py (FT, denoise, damp, FWHM,
Pade), which imports no JAX but is kept here so that the port imports
nothing of pycc_tpu:

* The Pade approximant to the discrete Fourier transform follows Bruner,
  LaMaster & Lopata, J. Chem. Theory Comput. 12, 3741 (2016): the signal's
  Z-transform  S(z) = sum_k c_k z^k  (z = exp(-i w dt)) is approximated by
  a diagonal [N/N] rational  A(z)/B(z)  with M = 2N + 1 samples.  Fixing
  b_0 = 1, the denominator coefficients solve the Toeplitz system
      sum_{m=1..N} b_m c_{N+j-m} = -c_{N+j},   j = 1..N,
  (eq. 29 of the paper), solved with the O(N^2) Levinson recursion
  (scipy.linalg.solve_toeplitz); the numerator follows from the Cauchy
  product  a_k = sum_{m<=k} b_m c_{k-m}  (one np.convolve).
* FWHM walks outward from the tallest power-spectrum bin to the half-max
  crossings with linear interpolation.

These run on host time series collected after a propagation (move device
tensors to the host first); nothing here touches a device.
"""

import warnings

import numpy as np
from scipy.linalg import solve_toeplitz


def FT(data, dt=1, norm=False, n=None):
    """Discrete Fourier transform of a time series sampled every `dt`.

    Returns ``(omega, spectrum)`` restricted to strictly positive angular
    frequencies (DC and the negative half are dropped).  With ``norm=True``
    the real and imaginary parts are independently rescaled to peak
    magnitude 1 (convenient for overlaying absorption/dispersion shapes).
    """
    data = np.asarray(data)
    if n is None:
        n = data.shape[0]
    bins = np.fft.fft(data, n=n)
    omega = 2.0 * np.pi * np.fft.fftfreq(n, d=dt)
    keep = slice(1, (n + 1) // 2)  # positive frequencies, DC excluded
    omega, bins = omega[keep], bins[keep]
    if norm:
        bins = (bins.real / np.abs(bins.real).max()
                + 1j * bins.imag / np.abs(bins.imag).max())
    return omega, bins


def denoise(f, filter_level, timestep):
    """Spectral gate: zero every Fourier bin whose periodogram power
    |F_k|^2 / n falls at or below `filter_level`, then transform back.

    `timestep` is accepted for API parity; a pure threshold filter does
    not depend on it.
    """
    f = np.asarray(f)
    n = f.shape[0]
    bins = np.fft.fft(f)
    keep = (bins * bins.conj()).real / n > filter_level
    cleaned = np.fft.ifft(np.where(keep, bins, 0.0))
    return cleaned if np.iscomplexobj(f) else cleaned.real


def damp(f, timestep, Tau):
    """Exponentially window the signal: f_k -> f_k * exp(-k*timestep/Tau).

    Broadens spectral lines to a Lorentzian of width ~2/Tau, suppressing
    the ringing of a finite propagation window.
    """
    f = np.asarray(f)
    return f * np.exp(-np.arange(f.shape[0]) * (timestep / Tau))


def FWHM(freq_f, timestep):
    """Full width at half maximum (in angular frequency) of the tallest
    line in the power spectrum of the already-transformed signal `freq_f`.

    Works on the positive-frequency half, locates the global maximum, and
    walks left/right to the half-power crossings with linear interpolation
    between bins.
    """
    freq_f = np.asarray(freq_f)
    n = freq_f.shape[0]
    power = (freq_f * freq_f.conj()).real / n
    half_n = n // 2
    p = power[1:half_n]  # positive frequencies, DC excluded
    dw = 2.0 * np.pi / (n * timestep)  # bin spacing in angular frequency

    k0 = int(np.argmax(p))
    target = 0.5 * p[k0]

    def _cross(direction):
        """Fractional bin distance from k0 to the half-power crossing."""
        k = k0
        while 0 < k + direction < len(p) - 1 and p[k + direction] > target:
            k += direction
        nxt = min(max(k + direction, 0), len(p) - 1)
        lo, hi = p[nxt], p[k]
        frac = (hi - target) / (hi - lo) if hi > lo else 1.0
        return abs(k - k0) + frac

    return (_cross(-1) + _cross(+1)) * dw


class Pade:
    """Diagonal [N/N] Pade approximant to the discrete Fourier transform
    of a time series (Bruner, LaMaster & Lopata, JCTC 12, 3741 (2016)).

    Resolves line positions from far shorter propagations than the FFT:
    the rational model extrapolates the signal beyond the sampled window.

    Parameters
    ----------
    data : array of M+1 = 2N+1 samples (even lengths are truncated by one)
    dt : sampling interval (atomic units)
    """

    def __init__(self, data, dt=1):
        data = np.array(data)
        if data.shape[0] % 2 == 0:
            warnings.warn("Pade needs an odd sample count; dropping the "
                          "final data point.")
            data = data[:-1]
        self.data = data
        self.dt = dt
        self.M = data.shape[0] - 1
        self.N = self.M // 2

    def build(self, toeplitz_solver=True):
        """Solve for the rational coefficients.

        ``toeplitz_solver=True`` uses the O(N^2) Levinson recursion on the
        Toeplitz system; ``False`` assembles the dense matrix and LU-solves
        it (an O(N^3) cross-check).
        """
        N, c = self.N, self.data
        rhs = -c[N + 1:2 * N + 1]
        if toeplitz_solver:
            try:
                col, row = c[N:2 * N], c[N:0:-1][:N]
                tail = solve_toeplitz((col, row), rhs)
            except np.linalg.LinAlgError:
                # Levinson needs nonsingular leading minors, which near-
                # periodic signals violate; fall back to least squares.
                j, m = np.ogrid[1:N + 1, 1:N + 1]
                tail = np.linalg.lstsq(c[N + j - m], rhs, rcond=None)[0]
        else:
            j, m = np.ogrid[1:N + 1, 1:N + 1]
            tail = np.linalg.solve(c[N + j - m], rhs)
        b = np.concatenate(([np.ones((), dtype=tail.dtype)], tail))
        # Cauchy product of the two power series, truncated at degree N
        a = np.convolve(b, c[:N + 1])[:N + 1]
        self.a, self.b = a, b

    def approx(self, o, norm=False):
        """Evaluate the approximant at angular frequencies `o`."""
        if not hasattr(self, "b"):
            raise AttributeError("call build() before approx()")
        z = np.exp(-1j * np.asarray(o) * self.dt)
        F = (np.polynomial.polynomial.polyval(z, self.a)
             / np.polynomial.polynomial.polyval(z, self.b))
        if norm:
            F = (F.real / np.abs(F.real).max()
                 + 1j * F.imag / np.abs(F.imag).max())
        return F
