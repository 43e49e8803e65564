"""Anisotropic power-spectrum model P(k, mu_k).

Counterpart of vega_tpu/power_spectrum.py: `compute_peak_smooth`
(vega_tpu/power_spectrum.py:203-320), dense and factored, with the
factors the synthetic auto+cross configuration uses: the static binning
window G(k), the Lorentzian velocity dispersion, the BAO peak broadening
and the division-free Kaiser polynomial. Every other factor raises
NotImplementedError naming its ROADMAP.md item.

Parameters arrive as a dict of Python floats and (B,) tensors; a factor
that reads only floats stays an unbatched (mu_k, k) grid, and a factor
that reads a (B,) tensor becomes (B, mu_k, k) (see `utils.col`).

The factored branch splits the Kaiser term into scalar coefficients times
static mu_k^2n grids (`FactoredPk`). Its basis part (`compute_peak_smooth`
with a `Sampling`) builds the grids once per sampled set; its coefficient
part (`kaiser_coefficients`) is what each evaluation runs, on (B,)
tensors, and never touches a grid.
"""

from __future__ import annotations

import numpy as np
import torch

from . import utils
from .factored import RecordingParams
from .utils import col, not_ported, to_tensor


class FactoredPk:
    """P(k, mu_k) = sum_t coeffs[t] * bases[t] (vega_tpu/power_spectrum.py:
    32-55): coefficients are floats or (B,) tensors, bases are (mu_k, k)
    grids, or (nodes, mu_k, k) when a grid parameter shaped them, that do
    not depend on sampled parameters. `grid_free` says that no factor
    read a grid parameter, so the bases are the same at every node."""

    __slots__ = ('coeffs', 'bases', 'grid_free', 'knots')

    def __init__(self, coeffs, bases, grid_free=True):
        if len(coeffs) != len(bases):
            raise ValueError('one basis grid per coefficient')
        self.coeffs = list(coeffs)
        self.bases = list(bases)
        self.grid_free = grid_free
        self.knots = None       # (xi, m) knot tables, set by PktoXi

    def dense(self):
        out = col(self.coeffs[0], 2) * self.bases[0]
        for c, b in zip(self.coeffs[1:], self.bases[1:]):
            out = out + col(c, 2) * b
        return out


def _grid_bundle(k_grid, num_bins_muk, quadrature, bin_size_rp,
                 bin_size_rt, use_Gk):
    """(mu_k, weights, k_par, k_trans, G(k)) host grids
    (vega_tpu/power_spectrum.py:66-106)."""
    if quadrature == 'midpoint':
        muk_grid = (np.arange(num_bins_muk) + 0.5) / num_bins_muk
        muk_weights = np.full(num_bins_muk, 1.0 / num_bins_muk)
    elif quadrature == 'gauss-legendre':
        nodes, gl_weights = np.polynomial.legendre.leggauss(num_bins_muk)
        muk_grid = (nodes + 1.0) / 2.0
        muk_weights = gl_weights / 2.0
    else:
        raise ValueError(
            f'Unknown muk-quadrature "{quadrature}" '
            '(use midpoint or gauss-legendre)')
    muk_grid = muk_grid[:, None]
    k_par_grid = k_grid * muk_grid
    k_trans_grid = k_grid * np.sqrt(1 - muk_grid ** 2)
    pk_Gk = None
    if use_Gk:
        gk = np.ones_like(k_par_grid)
        if bin_size_rp != 0:
            gk = gk * utils.np_sinc(k_par_grid * bin_size_rp / 2)
        if bin_size_rt != 0:
            gk = gk * utils.np_sinc(k_trans_grid * bin_size_rt / 2)
        pk_Gk = gk
    return muk_grid, muk_weights, k_par_grid, k_trans_grid, pk_Gk


class PowerSpectrum:
    """Power-spectrum model for one tracer pair (reference:
    power_spectrum.py:18-196)."""

    def __init__(self, config, fiducial, tracer1, tracer2, dataset_name=None,
                 *, device):
        self.device = torch.device(device)
        self.tracer1_name = tracer1['name']
        self.tracer2_name = tracer2['name']
        self.tracer1_type = tracer1['type']
        self.tracer2_type = tracer2['type']
        self._name = dataset_name

        self.k_grid = np.asarray(fiducial['k'], dtype=np.float64)
        self._bin_size_rp = config.getfloat('bin_size_rp')
        self._bin_size_rt = config.getfloat('bin_size_rt')
        self.use_Gk = config.getboolean('model binning', True)

        unported = {
            'pk-damping-scale': 'Pk damping', 'model-hcd': 'HCD model',
            'small scale nl': 'Small-scale non-linear models',
            'fullshape smoothing': 'Full-shape smoothing',
            'mock-bin-size': 'Mock binning window',
        }
        for option, feature in unported.items():
            if config.get(option, None) is not None:
                raise not_ported(feature, 10)
        for option, feature in (('UVB-fluctuations', 'UV fluctuations'),
                                ('HeII-reionization', 'HeII reionization'),
                                ('skip-nl-model-in-peak',
                                 'skip-nl-model-in-peak')):
            if config.getboolean(option, False):
                raise not_ported(feature, 10)
        self.velocity_dispersion = config.get('velocity dispersion', None)
        if self.velocity_dispersion not in (None, 'lorentz'):
            raise not_ported(
                f'Velocity dispersion "{self.velocity_dispersion}"', 10)

        num_bins_muk = config.getint('num_bins_muk', 1000)
        quadrature = config.get('muk-quadrature', 'midpoint')
        (muk_grid, self.muk_weights, k_par_grid, k_trans_grid,
         pk_Gk) = _grid_bundle(self.k_grid, num_bins_muk, quadrature,
                               self._bin_size_rp, self._bin_size_rt,
                               self.use_Gk)
        self.muk_grid = muk_grid                      # host (mu_k, 1)
        self._muk_t = to_tensor(muk_grid, self.device)
        # mu_k^0, mu_k^2, mu_k^4 basis grids of the factored Kaiser term,
        # built as vega_tpu/power_spectrum.py:407-419 builds them
        muk2 = muk_grid ** 2 * np.ones_like(self.k_grid)
        self._mu_pow_grids = {
            0: to_tensor(np.ones_like(muk_grid) * np.ones_like(self.k_grid),
                         self.device),
            2: to_tensor(muk2, self.device),
            4: to_tensor(muk2 * muk2, self.device)}
        self.set_constants(k_par_grid, k_trans_grid, pk_Gk)

    def set_constants(self, k_par_grid, k_trans_grid, pk_Gk):
        """Install the host (mu_k, k) grids as device tensors."""
        self.k_par_grid = to_tensor(k_par_grid, self.device)
        self.k_trans_grid = to_tensor(k_trans_grid, self.device)
        self.pk_Gk = None if pk_Gk is None else to_tensor(pk_Gk, self.device)

    # ------------------------------------------------------------------
    def compute_peak_smooth(self, params, pk_peak_lin, pk_smooth_lin,
                            sampling=None):
        """Both components of one evaluation: (pk_peak, pk_smooth, bad)
        (vega_tpu/power_spectrum.py:203-320). Factors are multiplied in
        the JAX package's order: static accumulator first, the (typically
        batched) Kaiser polynomial last.

        With a `Sampling` whose sampled set is not empty, and when no
        common or peak factor read a sampled name that is not a grid
        name, both components come back as FactoredPk
        (vega_tpu/power_spectrum.py:298-315)."""
        if (f'par binsize {self._name}' in params
                or f'per binsize {self._name}' in params):
            raise not_ported('Per-dataset binsize parameters', 10)

        def mul(acc, fac):
            if fac is None:
                return acc
            return fac if acc is None else acc * fac

        rec_common = RecordingParams(params, sampling)
        common = None
        if self.use_Gk:
            common = mul(common, self.pk_Gk)
        if self.velocity_dispersion == 'lorentz':
            common = mul(common,
                         self.compute_velocity_dispersion_lorentz(rec_common))
        rec_peak = RecordingParams(params, sampling)
        peak_nl = self.compute_peak_nl(rec_peak)

        smooth_static = mul(pk_smooth_lin, common)
        peak_static = mul(mul(pk_peak_lin, common), peak_nl)

        if (sampling is not None and sampling.sampled
                and not (rec_common.traced() or rec_peak.traced())):
            grid_free = not any(key in sampling.grid for key in
                                rec_common.accessed + rec_peak.accessed)
            coeffs, mupows = zip(*self._kaiser_product_terms(params))
            grids = [self._mu_pow_grids[p] for p in mupows]
            return (FactoredPk(coeffs, [peak_static * g for g in grids],
                               grid_free),
                    FactoredPk(coeffs, [smooth_static * g for g in grids],
                               grid_free),
                    False)

        kaiser = self.compute_kaiser_poly(params)
        return peak_static * kaiser, smooth_static * kaiser, False

    # ------------------------------------------------------------------
    # Kaiser decomposition for the factored path
    # ------------------------------------------------------------------
    @staticmethod
    def _tracer_poly_terms(bias, beta):
        """One tracer's Kaiser polynomial b + b beta mu_k^2 as
        [(coeff, key, mupow)] (vega_tpu/power_spectrum.py:325-362; the
        HCD and UV keys are not ported, those models raise at init)."""
        return [(bias, 'one', 0), (bias * beta, 'one', 2)]

    def _kaiser_product_terms(self, params):
        """The Kaiser factor as merged [(coeff, mupow)] product terms, in
        the order of vega_tpu/power_spectrum.py:377-421: the coefficient
        of the mu_k^mupow basis grid."""
        bias1, beta1, bias2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)
        merged = {}
        for c1, k1, p1 in self._tracer_poly_terms(bias1, beta1):
            for c2, k2, p2 in self._tracer_poly_terms(bias2, beta2):
                key = (tuple(sorted([repr(k1), repr(k2)])), p1 + p2)
                coeff = c1 * c2
                if key in merged:
                    merged[key] = (merged[key][0] + coeff, p1 + p2)
                else:
                    merged[key] = (coeff, p1 + p2)
        return list(merged.values())

    def kaiser_coefficients(self, params):
        """The coefficient part of the factored Kaiser term: floats or
        (B,) tensors, one per basis grid."""
        return [c for c, _ in self._kaiser_product_terms(params)]

    def compute_kaiser_poly(self, params):
        """Kaiser factor (b1 + b1 beta1 mu_k^2)(b2 + b2 beta2 mu_k^2),
        (mu_k, 1) or (B, mu_k, 1) (vega_tpu/power_spectrum.py:423-460
        without HCD and UV terms)."""
        b1, beta1, b2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)
        bb1, bb2 = b1 * beta1, b2 * beta2
        muk2 = self._muk_t ** 2
        return ((col(b1, 2) + col(bb1, 2) * muk2)
                * (col(b2, 2) + col(bb2, 2) * muk2))

    def compute_peak_nl(self, params):
        """BAO peak non-linear broadening (vega_tpu/power_spectrum.py:
        601-616)."""
        sigma_par = params.get('sigmaNL_par', None)
        sigma_trans = params.get('sigmaNL_per', None)
        growth_rate = params.get('growth_rate')
        if sigma_par is None and sigma_trans is not None:
            sigma_par = sigma_trans * (1 + growth_rate)
        elif sigma_trans is None and sigma_par is not None:
            sigma_trans = sigma_par / (1 + growth_rate)
        elif sigma_par is None and sigma_trans is None:
            raise ValueError('No parameters for peak NL found. '
                             'Add sigmaNL_par and/or sigmaNL_per.')
        peak_nl = (self.k_par_grid ** 2 * col(sigma_par, 2) ** 2
                   + self.k_trans_grid ** 2 * col(sigma_trans, 2) ** 2)
        return torch.exp(-peak_nl / 2)

    def compute_velocity_dispersion_lorentz(self, params):
        """Lorentzian velocity dispersion (vega_tpu/power_spectrum.py:
        747-758)."""
        if 'discrete' not in (self.tracer1_type, self.tracer2_type):
            raise ValueError('Velocity dispersion needs a discrete tracer')
        smoothing = 1.
        for name, kind in ((self.tracer1_name, self.tracer1_type),
                           (self.tracer2_name, self.tracer2_type)):
            if kind == 'discrete':
                sigma = col(params['sigma_velo_disp_lorentz_' + name], 2)
                smoothing = smoothing / torch.sqrt(
                    1 + (self.k_par_grid * sigma) ** 2)
        return smoothing * torch.ones_like(self.k_par_grid)
