"""FFTLog Hankel transform P_ell(k) -> xi_ell(r) as a dense linear operator.

The reference does this per likelihood call with mcfit's P2xi (FFT + Gamma
coefficients; reference: pktoxi.py:53,141 and the documented legacy
algorithm at pktoxi.py:230-279). On TPU we exploit that for a *fixed* k
grid the whole transform

    xi_ell(r_j) = (-1)^(ell/2)/(2 pi^2) * Integral dk k^2 j_ell(k r) P_ell(k)

under the FFTLog log-periodic discretization (Hamilton 2000) is a LINEAR
map of the sampled P_ell values. We therefore precompute the dense
(N x N) operator once on the host (f64 numpy FFTs) and the per-eval work
becomes one f64 GEMM on the device.

A copy of the operator builders of vega_tpu/ops/fftlog.py (numpy only),
pinned to them by tests/test_torch_host.py, with its inverse transform
(`FFTLogXi2P`) and the padded transform of the template tools
(`extrapolated_transform`, scripts/make_template.py), pinned by
tests/test_torch_config_tools.py. The environment overrides of
the JAX package (VEGA_TPU_LOWRING, VEGA_TPU_FFT_PAD) are not carried:
the port always takes the default branch and padding.

Conventions (chosen to match mcfit.P2xi(k, l=ell, lowring=True) with its
default tilt q=1.5, i.e. the symmetric form):

- k must be log-spaced; Delta = ln(k[-1]/k[0]) / (N-1).
- output grid r_j = xy / k[N-1-j], with ln(xy) set by the low-ringing
  condition (scipy.fft.fhtoffset equivalent).
- u_m = xy^(-2 pi i m / (N Delta)) * U_mu(1 + 2 pi i m/(N Delta)),
  U_mu(z) = 2^(z-1) Gamma((mu+z)/2) / Gamma((mu-z)/2 + 1), mu = ell + 1/2.
- xi(r_j) = C_ell sqrt(pi/2) r_j^(-3/2) * reverse(ifft(fft(P_ell k^(3/2)) u))_j
"""

from __future__ import annotations

import numpy as np
from scipy.special import loggamma


# Which low-ringing offset branch to use. Both satisfy the condition that
# the Nyquist coefficient u_{N/2} is real (mod pi); they differ by integer
# multiples of the grid spacing:
#   'principal' — ln(xy) = (Delta/pi) * Arg U(1 + i pi/Delta), the
#                 principal angle.
#   'nearest'   — the offset closest to 0 (scipy.fft.fhtoffset convention;
#                 also what mcfit lands on for these grids). Validated
#                 empirically: with 'nearest' the end-to-end log-likelihood
#                 on the reference's 4-correlation test config agrees with
#                 the reference value to 5e-10 relative (within its own
#                 math.isclose tolerance); 'principal' is 20x worse.
LOWRING_BRANCH = 'nearest'


def lowring_offset(delta: float, mu: float,
                   branch: str = LOWRING_BRANCH) -> float:
    """ln(xy) satisfying the low-ringing condition: the Nyquist
    coefficient u_{N/2} is real, killing the sawtooth ringing mode."""
    # arg U_mu(1 + i pi / delta)
    z = 1.0 + 1j * np.pi / delta
    lg = loggamma((mu + z) / 2) - loggamma((mu - z) / 2 + 1)
    u = np.exp((z - 1) * np.log(2.0) + lg)
    lnxy = (delta / np.pi) * np.angle(u)
    if branch == 'nearest':
        # condition holds mod pi -> allowed offsets are spaced delta apart
        lnxy -= delta * np.round(lnxy / delta)
    return lnxy


def _u_coefficients(n: int, delta: float, mu: float, lnxy: float) -> np.ndarray:
    """Complex FFTLog kernel coefficients u_m for all FFT frequencies."""
    m = np.fft.fftfreq(n) * n  # 0, 1, ..., -1
    alpha = 2j * np.pi * m / (n * delta)
    z = 1.0 + alpha
    lg = loggamma((mu + z) / 2) - loggamma((mu - z) / 2 + 1)
    u = np.exp((z - 1) * np.log(2.0) + lg - alpha * lnxy)
    # m = 0 term is real analytically; enforce against roundoff
    u[0] = u[0].real
    if n % 2 == 0:
        # Nyquist term must be real for a real output; exact under lowring
        u[n // 2] = u[n // 2].real
    return u


def default_pad_size(n_in: int) -> int:
    """mcfit's default convolution size: the smallest power of 2 that at
    least doubles the input length (mcfit.mcfit N=None default)."""
    return 2 ** int(np.ceil(np.log2(2 * n_in)))


class FFTLogP2Xi:
    """P_ell(k) -> xi_ell(r) transform for one multipole on a fixed k grid.

    Precomputes the output r grid and the dense operator matrix. Also
    offers a direct numpy `transform` used for validation.

    ``pad_to`` selects the FFT convolution length N >= n_in; the input is
    zero-padded symmetrically in log k (matching mcfit's extrap=False call
    path, the reference default at pktoxi.py:41,141) which lengthens the
    log-periodic domain and suppresses aliasing ringing. ``pad_to=None``
    reproduces mcfit's default power-of-two doubling; ``pad_to=0`` keeps
    the unpadded N = n_in transform.
    """

    def __init__(self, k_grid: np.ndarray, ell: int, lowring: bool = True,
                 pad_to: int | None = None):
        k = np.asarray(k_grid, dtype=np.float64)
        n = len(k)
        delta = np.log(k[-1] / k[0]) / (n - 1)
        # verify log spacing
        ratios = np.diff(np.log(k))
        if not np.allclose(ratios, delta, rtol=1e-8, atol=1e-10):
            raise ValueError('FFTLog requires a log-spaced k grid')

        if pad_to is None:
            pad_to = default_pad_size(n)
        n_fft = max(int(pad_to), n)

        self.ell = ell
        self.k_grid = k
        self.n = n
        self.n_fft = n_fft
        self.delta = delta
        mu = ell + 0.5
        lnxy = lowring_offset(delta, mu) if lowring else 0.0
        self.lnxy = lnxy

        # Output grid: r_j = xy / k[n-1-j] (independent of padding)
        self.r_grid = np.exp(lnxy) / k[::-1]

        self._u = _u_coefficients(n_fft, delta, mu, lnxy)
        # zero-pad split (result is exactly rotation-invariant in the
        # split; mirror mcfit's centered choice)
        n_pad = n_fft - n
        self._pad_l = n_pad // 2
        self._prefac = k ** 1.5
        sign = -1.0 if (ell // 2) % 2 else 1.0
        self._postfac = (
            sign / (2 * np.pi ** 2) * np.sqrt(np.pi / 2) * self.r_grid ** -1.5
        )

    def _convolve(self, a: np.ndarray) -> np.ndarray:
        """Padded log-convolution along the last axis: input (..., n) ->
        output (..., n) already reversed onto the increasing-r grid."""
        n, n_fft, pad_l = self.n, self.n_fft, self._pad_l
        shape = a.shape[:-1] + (n_fft,)
        f = np.zeros(shape, dtype=np.float64)
        f[..., pad_l:pad_l + n] = a
        g = np.fft.ifft(np.fft.fft(f, axis=-1) * self._u, axis=-1).real
        return g[..., pad_l:pad_l + n][..., ::-1]

    def transform(self, pk_ell: np.ndarray) -> np.ndarray:
        """Direct numpy evaluation (validation / host path)."""
        a = np.asarray(pk_ell, dtype=np.float64) * self._prefac
        return self._postfac * self._convolve(a)

    def operator(self) -> np.ndarray:
        """Dense (n, n) matrix M with xi = M @ pk_ell.

        Built by pushing the DFT through explicitly; exact (same float ops
        up to reassociation) as `transform`.
        """
        n = self.n
        # Apply the transform to the identity, batched over columns.
        a = np.eye(n) * self._prefac[None, :]
        m = self._convolve(a) * self._postfac[None, :]
        return np.ascontiguousarray(m.T)


class FFTLogXi2P:
    """Inverse transform xi_ell(r) -> P_ell(k) on a fixed log-spaced r
    grid: P_ell(k) = 4 pi (-1)^(ell/2) Integral r^2 dr j_ell(kr) xi_ell(r).

    Same FFTLog discretization as FFTLogP2Xi with the roles of the grids
    swapped (used by the template side-band machinery; the reference uses
    mcfit.xi2P in bin/make_template.py:26-29).
    """

    def __init__(self, r_grid: np.ndarray, ell: int, lowring: bool = True,
                 pad_to: int | None = None):
        r = np.asarray(r_grid, dtype=np.float64)
        n = len(r)
        delta = np.log(r[-1] / r[0]) / (n - 1)
        if pad_to is None:
            pad_to = default_pad_size(n)
        n_fft = max(int(pad_to), n)
        self.ell = ell
        self.r_grid = r
        self.n = n
        self.n_fft = n_fft
        mu = ell + 0.5
        lnxy = lowring_offset(delta, mu) if lowring else 0.0
        self.lnxy = lnxy
        self.k_grid = np.exp(lnxy) / r[::-1]

        self._u = _u_coefficients(n_fft, delta, mu, lnxy)
        self._pad_l = (n_fft - n) // 2
        self._prefac = r ** 1.5
        sign = -1.0 if (ell // 2) % 2 else 1.0
        # 4 pi * sqrt(pi/2) against the forward's 1/(2 pi^2) sqrt(pi/2)
        self._postfac = (sign * 4 * np.pi * np.sqrt(np.pi / 2)
                         * self.k_grid ** -1.5)

    def transform(self, xi_ell: np.ndarray) -> np.ndarray:
        a = np.asarray(xi_ell, dtype=np.float64) * self._prefac
        n, n_fft, pad_l = self.n, self.n_fft, self._pad_l
        f = np.zeros(a.shape[:-1] + (n_fft,), dtype=np.float64)
        f[..., pad_l:pad_l + n] = a
        hk = np.fft.ifft(np.fft.fft(f, axis=-1) * self._u, axis=-1).real
        return self._postfac * hk[..., pad_l:pad_l + n][..., ::-1]


def extrapolated_transform(fftlog_cls, x, f, ell=0, pad_factor=2,
                           keep='center'):
    """Run a transform with power-law padding of the input on both ends
    (the role of mcfit's extrap=True; used for smooth template work, not
    the likelihood hot path).

    Returns (y_grid, transformed): the reciprocal of the original x range
    (keep='center') or the full padded output (keep='all').
    """
    x = np.asarray(x, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    n = len(x)
    n_pad = (pad_factor - 1) * n // 2
    delta = np.log(x[-1] / x[0]) / (n - 1)

    x_lo = x[0] * np.exp(-delta * np.arange(n_pad, 0, -1))
    x_hi = x[-1] * np.exp(delta * np.arange(1, n_pad + 1))

    def _slope(f0, f1, safe):
        return np.log(np.abs(f1 / f0)) / delta if safe else 0.0

    lo_safe = f[0] != 0 and f[1] != 0 and np.sign(f[0]) == np.sign(f[1])
    hi_safe = f[-1] != 0 and f[-2] != 0 and np.sign(f[-1]) == np.sign(f[-2])
    slope_lo = _slope(f[0], f[1], lo_safe)
    slope_hi = _slope(f[-2], f[-1], hi_safe)
    f_lo = f[0] * (x_lo / x[0]) ** slope_lo if lo_safe else np.zeros(n_pad)
    f_hi = f[-1] * (x_hi / x[-1]) ** slope_hi if hi_safe else np.zeros(n_pad)

    x_full = np.concatenate([x_lo, x, x_hi])
    f_full = np.concatenate([f_lo, f, f_hi])

    tr = fftlog_cls(x_full, ell)
    out = tr.transform(f_full)
    y = tr.k_grid if hasattr(tr, 'k_grid') and fftlog_cls is FFTLogXi2P \
        else tr.r_grid
    if keep == 'all':
        return y, out
    sl = slice(n_pad, n_pad + n)
    return y[sl], out[sl]
