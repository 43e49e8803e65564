"""Anisotropic power-spectrum model P(k, mu_k).

Counterpart of vega_tpu/power_spectrum.py: `compute_peak_smooth`
(vega_tpu/power_spectrum.py:203-320), dense and factored, and the
single-component `compute` the metal correlations use, with the factors
of the DR16, DESI and mock configurations: Pk damping, the binning
window G(k), static or with the per-dataset `par / per binsize <name>`
parameters, the mock binning window (`mock-bin-size`,
`mock-los-smoothing`), the Lorentzian, Gaussian or `lorentz_gauss`
velocity dispersion, the BAO peak broadening, the HCD effective biases
(Rogers, fvoigt, sinc), the small-scale non-linear terms (Arinyo,
McDonald), the full-shape smoothing (gauss, gauss_iso, exp; left out of
the peak with the NL term under `skip-nl-model-in-peak`) and the
division-free Kaiser polynomial with the UV background fluctuations and
HeII reionization shifts of the LYA bias (`UVB-fluctuations`,
`HeII-reionization`).

Parameters arrive as a dict of Python floats and (B,) tensors; a factor
that reads only floats stays an unbatched (mu_k, k) grid, and a factor
that reads a (B,) tensor becomes (B, mu_k, k) (see `utils.col`).

The factored branch splits the Kaiser term into scalar coefficients times
static grids, mu_k^2n times the HCD profile to the power 0, 1 or 2
(`FactoredPk`). Its basis part (`compute_peak_smooth`
with a `Sampling`) builds the grids once per sampled set; its coefficient
part (`kaiser_coefficients`) is what each evaluation runs, on (B,)
tensors, and never touches a grid.
"""

from __future__ import annotations

import numpy as np
import torch

from . import utils
from .factored import RecordingParams
from .utils import col, to_tensor


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


# host grid bundles by k grid, mu_k bins, quadrature, bin sizes and G(k):
# a correlation's core model and each of its metal pairs, and every
# interface of a process on the same template, share one, read-only
# (vega_tpu/power_spectrum.py:63-106 keeps the same cache)
_GRID_BUNDLE_CACHE = {}


def _grid_bundle(k_grid, num_bins_muk, quadrature, bin_size_rp,
                 bin_size_rt, use_Gk):
    """(mu_k, weights, k_par, k_trans, G(k)) host grids
    (vega_tpu/power_spectrum.py:66-106), built once per key."""
    key = (np.asarray(k_grid, dtype=np.float64).tobytes(), num_bins_muk,
           quadrature, bin_size_rp, bin_size_rt, use_Gk)
    bundle = _GRID_BUNDLE_CACHE.get(key)
    if bundle is None:
        bundle = _build_grid_bundle(k_grid, num_bins_muk, quadrature,
                                    bin_size_rp, bin_size_rt, use_Gk)
        for array in bundle:
            if array is not None:
                array.flags.writeable = False
        _GRID_BUNDLE_CACHE[key] = bundle
    return bundle


def _build_grid_bundle(k_grid, num_bins_muk, quadrature, bin_size_rp,
                       bin_size_rt, use_Gk):
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
                 *, device, dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        self.tracer1_name = tracer1['name']
        self.tracer2_name = tracer2['name']
        self._corr_name = f'{self.tracer1_name}x{self.tracer2_name}'
        self.tracer1_type = tracer1['type']
        self.tracer2_type = tracer2['type']
        self._name = dataset_name

        self.k_grid = np.asarray(fiducial['k'], dtype=np.float64)
        self._bin_size_rp = config.getfloat('bin_size_rp')
        self._bin_size_rt = config.getfloat('bin_size_rt')
        self.use_Gk = config.getboolean('model binning', True)

        self.skip_nl_model_in_peak = config.getboolean(
            'skip-nl-model-in-peak', False)
        self.pk_damping_scale = config.getfloat('pk-damping-scale', None)
        self.pk_damping_power = config.getint('pk-damping-power', 2)
        self._add_uvb = config.getboolean('UVB-fluctuations', False)
        self._add_heii = config.getboolean('HeII-reionization', False)
        self.fullshape_smoothing = config.get('fullshape smoothing', None)
        self.velocity_dispersion = config.get('velocity dispersion', None)
        self.mock_bin_size = config.getfloat('mock-bin-size', None)
        self.mock_los_smoothing = config.get('mock-los-smoothing', None)

        self.hcd_model = config.get('model-hcd', None)
        if self.hcd_model is not None and not any(
                kind in self.hcd_model
                for kind in ('Rogers', 'fvoigt', 'sinc')):
            raise ValueError(f'Unknown hcd model {self.hcd_model}. '
                             "Choose from ['Rogers', 'fvoigt', 'sinc']")
        self.small_scale_nl = config.get('small scale nl', None)
        if self.small_scale_nl is not None and not any(
                kind in self.small_scale_nl
                for kind in ('arinyo', 'mcdonald')):
            raise ValueError("Incorrect 'small scale nl' specified")
        # Fvoigt HCD profile table (vega_tpu/power_spectrum.py:145-155),
        # read from the JAX package's models directory by path
        self._fvoigt = None
        if self.hcd_model is not None and 'fvoigt' in self.hcd_model:
            if 'fvoigt_model' not in config.keys():
                raise ValueError('No fvoigt_model specified in config')
            fvoigt_model = config.get('fvoigt_model')
            path = (fvoigt_model if '/' in fvoigt_model else utils.find_file(
                f'fvoigt_models/Fvoigt_{fvoigt_model}.txt'))
            table = np.loadtxt(path)
            self._fvoigt = (to_tensor(table[:, 0], self.device, dtype),
                            to_tensor(table[:, 1], self.device, dtype))

        # Delta^2(k) of the fiducial Pk rescaled to z_eff, for the Arinyo
        # term (vega_tpu/power_spectrum.py:157-160,640)
        pk_fid = np.asarray(fiducial['pk_full']) * (
            (1 + fiducial['z_fiducial']) / (1. + fiducial['z_eff'])) ** 2
        self._k_t = to_tensor(self.k_grid, self.device, dtype)
        self._delta_sq = to_tensor(
            self.k_grid ** 3 * pk_fid / (2 * np.pi ** 2), self.device, dtype)
        # Pk damping exp(-s^2 k^p / 2), a (k,) factor that reads no
        # parameter (vega_tpu/power_spectrum.py:219-222)
        self._pk_damping = None
        if self.pk_damping_scale is not None:
            self._pk_damping = torch.exp(
                -self.pk_damping_scale ** 2
                * self._k_t ** self.pk_damping_power / 2)

        num_bins_muk = config.getint('num_bins_muk', 1000)
        quadrature = config.get('muk-quadrature', 'midpoint')
        (muk_grid, self.muk_weights, k_par_grid, k_trans_grid,
         pk_Gk) = _grid_bundle(self.k_grid, num_bins_muk, quadrature,
                               self._bin_size_rp, self._bin_size_rt,
                               self.use_Gk)
        self.muk_grid = muk_grid                      # host (mu_k, 1)
        self._muk_t = to_tensor(muk_grid, self.device, dtype)
        # mu_k^0, mu_k^2, mu_k^4 basis grids of the factored Kaiser term,
        # built as vega_tpu/power_spectrum.py:407-419 builds them
        muk2 = muk_grid ** 2 * np.ones_like(self.k_grid)
        self._mu_pow_grids = {
            0: to_tensor(np.ones_like(muk_grid) * np.ones_like(self.k_grid),
                         self.device, dtype),
            2: to_tensor(muk2, self.device, dtype),
            4: to_tensor(muk2 * muk2, self.device, dtype)}
        self.set_constants(k_par_grid, k_trans_grid, pk_Gk)

    def set_constants(self, k_par_grid, k_trans_grid, pk_Gk):
        """Install the host (mu_k, k) grids as device tensors."""
        self.k_par_grid = to_tensor(k_par_grid, self.device, self.dtype)
        self.k_trans_grid = to_tensor(k_trans_grid, self.device, self.dtype)
        self.pk_Gk = (None if pk_Gk is None
                      else to_tensor(pk_Gk, self.device, self.dtype))

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
        def mul(acc, fac):
            if fac is None:
                return acc
            return fac if acc is None else acc * fac

        rec_common = RecordingParams(params, sampling)
        common = self._common_factors(rec_common)

        # Non-linear factors (vega_tpu/power_spectrum.py:267-286)
        rec_nl = RecordingParams(params, sampling)
        nl, bad = self._nl_factor(rec_nl)

        rec_peak = RecordingParams(params, sampling)
        peak_nl = self.compute_peak_nl(rec_peak)

        smooth_static = mul(mul(pk_smooth_lin, common), nl)
        # skip-nl-model-in-peak leaves the NL factor out of the peak
        # alone (vega_tpu/power_spectrum.py:291-295)
        peak_static = mul(pk_peak_lin, common)
        if not self.skip_nl_model_in_peak:
            peak_static = mul(peak_static, nl)
        peak_static = mul(peak_static, peak_nl)

        if (sampling is not None and sampling.sampled
                and not (rec_common.traced() or rec_nl.traced()
                         or rec_peak.traced())):
            terms = self._kaiser_product_terms(params, sampling)
            if terms is not None:
                grid_free = not any(
                    key in sampling.grid for key in rec_common.accessed
                    + rec_nl.accessed + rec_peak.accessed)
                coeffs = [c for c, _ in terms]
                grids = self._kaiser_basis_grids([key for _, key in terms],
                                                 params)
                return (FactoredPk(coeffs, [peak_static * g for g in grids],
                                   grid_free),
                        FactoredPk(coeffs,
                                   [smooth_static * g for g in grids],
                                   grid_free),
                        bad)

        kaiser = self.compute_kaiser_poly(params)
        return peak_static * kaiser, smooth_static * kaiser, bad

    def _common_factors(self, params):
        """The factors shared by the peak and the smooth component, or
        None, multiplied in vega_tpu's order
        (vega_tpu/power_spectrum.py:217-265): Pk damping, G(k), the mock
        binning window, the velocity dispersion."""
        common = self._pk_damping
        factors = []
        if self.use_Gk:
            factors.append(self._binning_window(params))
        if self.mock_bin_size is not None:
            factors.append(self._compute_mock_binsize_gk(params))
        factors += self._velocity_dispersion_factors(params)
        for factor in factors:
            common = factor if common is None else common * factor
        return common

    def _nl_factor(self, params):
        """(NL factor or None, bad flag): the small-scale NL term (Arinyo
        with its not-finite flag, or McDonald), then the full-shape
        smoothing (vega_tpu/power_spectrum.py:267-286)."""
        nl, bad = None, False
        if self.small_scale_nl is not None:
            if 'arinyo' in self.small_scale_nl:
                nl, bad = self.compute_dnl_arinyo(params)
            else:
                nl = self.compute_dnl_mcdonald()
        smoothing = self._fullshape_smoothing(params)
        if smoothing is not None:
            nl = smoothing if nl is None else nl * smoothing
        return nl, bad

    def _fullshape_smoothing(self, params):
        """The full-shape smoothing factor, or None: 'gauss' (and
        'gauss_iso') or 'exp' (vega_tpu/power_spectrum.py:279-286)."""
        if self.fullshape_smoothing is None:
            return None
        if 'gauss' in self.fullshape_smoothing:
            return self.compute_fullshape_gauss_smoothing(params)
        if 'exp' in self.fullshape_smoothing:
            return self.compute_fullshape_exp_smoothing(params)
        raise ValueError('"fullshape smoothing" must be "gauss" or "exp"')

    def _velocity_dispersion_factors(self, params):
        """The velocity dispersion's factors, in the order they multiply:
        'lorentz_gauss' the Lorentzian then the Gaussian, else one of
        them (vega_tpu/power_spectrum.py:247-266)."""
        kind = self.velocity_dispersion
        if kind is None:
            return []
        if 'lorentz_gauss' in kind:
            return [self.compute_velocity_dispersion_lorentz(params),
                    self.compute_velocity_dispersion_gauss(params)]
        if 'gauss' in kind:
            return [self.compute_velocity_dispersion_gauss(params)]
        if 'lorentz' in kind:
            return [self.compute_velocity_dispersion_lorentz(params)]
        raise ValueError('"velocity dispersion" must be "gauss" or "lorentz"')

    def compute(self, pk_lin, params, fast_metals=False):
        """One component: P(k, mu_k) = pk_lin x every factor, returns
        (pk, bad) (vega_tpu/power_spectrum.py:189-201,462-535; the metal
        correlations' unrolled path), the factors in `_shared_factor`'s
        order: Kaiser, small-scale NL, G(k), mock binning, full-shape
        smoothing, velocity dispersion, Pk damping, then the peak
        broadening; the UV / HeII and then the HCD effective biases of a
        LYA tracer enter the Kaiser term. fast_metals leaves the bias
        product out of the Kaiser term; skip-nl-model-in-peak leaves the NL term and the
        smoothing out of the peak component."""
        peak = bool(params['peak'])
        skip_nl = self.skip_nl_model_in_peak and peak
        bias1, beta1, bias2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)
        if self._add_uvb or self._add_heii:
            if self.tracer1_name == 'LYA':
                bias1, beta1 = self.compute_bias_beta_uv_heii(bias1, beta1,
                                                              params)
            if self.tracer2_name == 'LYA':
                bias2, beta2 = self.compute_bias_beta_uv_heii(bias2, beta2,
                                                              params)
        if self.hcd_model is not None:
            if self.tracer1_name == 'LYA':
                bias1, beta1 = self.compute_bias_beta_hcd(bias1, beta1,
                                                          params)
            if self.tracer2_name == 'LYA':
                bias2, beta2 = self.compute_bias_beta_hcd(bias2, beta2,
                                                          params)
        factors = [self.compute_kaiser(bias1, beta1, bias2, beta2,
                                       fast_metals)]
        bad = False
        if self.small_scale_nl is not None and not skip_nl:
            if 'arinyo' in self.small_scale_nl:
                dnl, bad = self.compute_dnl_arinyo(params)
                factors.append(dnl)
            else:
                factors.append(self.compute_dnl_mcdonald())
        if self.use_Gk:
            factors.append(self._binning_window(params))
        if self.mock_bin_size is not None:
            factors.append(self._compute_mock_binsize_gk(params))
        if not skip_nl:
            smoothing = self._fullshape_smoothing(params)
            if smoothing is not None:
                factors.append(smoothing)
        factors += self._velocity_dispersion_factors(params)
        if self._pk_damping is not None:
            factors.append(self._pk_damping)
        factor = factors[0]
        for f in factors[1:]:
            factor = factor * f
        pk_full = pk_lin * factor
        if peak:
            pk_full = pk_full * self.compute_peak_nl(params)
        return pk_full, bad

    def _binning_window(self, params):
        """G(k): with this dataset's `par / per binsize <name>` when the
        parameters carry them, else the static window of the data's bin
        sizes."""
        if (f'par binsize {self._name}' in params
                or f'per binsize {self._name}' in params):
            return self.compute_Gk(params)
        return self.pk_Gk

    def compute_Gk(self, params):
        """The binning window with the per-dataset `par / per binsize
        <name>` parameters in place of the data's bin sizes
        (vega_tpu/power_spectrum.py:653-668): (mu_k, k), or (B, mu_k, k)
        for a batched bin size."""
        bin_size_rp = params.get(f'par binsize {self._name}',
                                 self._bin_size_rp)
        bin_size_rt = params.get(f'per binsize {self._name}',
                                 self._bin_size_rt)
        gk = 1.
        if not (isinstance(bin_size_rp, float) and bin_size_rp == 0):
            gk = gk * utils.sinc(self.k_par_grid * col(bin_size_rp, 2) / 2)
        if not (isinstance(bin_size_rt, float) and bin_size_rt == 0):
            gk = gk * utils.sinc(self.k_trans_grid * col(bin_size_rt, 2) / 2)
        return gk

    # ------------------------------------------------------------------
    # Kaiser decomposition for the factored path
    # ------------------------------------------------------------------
    HCD_SHAPE_PARAMS = ('L0_hcd', 'L0_fvoigt', 'L0_sinc')

    def _hcd_bias_beta(self, params):
        """(bias_hcd, beta_hcd), the correlation's own where given."""
        bias_hcd = params.get(f'bias_hcd_{self._corr_name}')
        if bias_hcd is None:
            bias_hcd = params['bias_hcd']
        beta_hcd = params.get(f'beta_hcd_{self._corr_name}')
        if beta_hcd is None:
            beta_hcd = params['beta_hcd']
        return bias_hcd, beta_hcd

    def _tracer_poly_terms(self, params, name, bias, beta, sampling=None):
        """One tracer's Kaiser polynomial b_eff + bb_eff mu_k^2 as
        [(coeff, key, mupow)], key 'one', 'hcd' or ('uv', lambda, b_prim)
        naming a grid that no sampled parameter shapes
        (vega_tpu/power_spectrum.py:325-362): the UV and HeII terms shift
        b_eff alone, with coefficients bias_gamma and bias_gamma_e. None
        when a parameter that shapes the HCD profile or a UV / HeII grid
        is sampled (a grid parameter among them)."""
        b_terms = [(bias, 'one')]
        bb_terms = [(bias * beta, 'one')]
        if name == 'LYA':
            for on, lam_name, gamma_name in (
                    (self._add_uvb, 'lambda_uv', 'bias_gamma'),
                    (self._add_heii, 'lambda_HeII', 'bias_gamma_e')):
                if not on:
                    continue
                if sampling is not None and (
                        lam_name in sampling.sampled
                        or 'bias_prim' in sampling.sampled):
                    return None
                b_terms.append((params[gamma_name],
                                ('uv', params[lam_name], params['bias_prim'])))
        if self.hcd_model is not None and name == 'LYA':
            if sampling is not None and any(
                    key in sampling.sampled for key in self.HCD_SHAPE_PARAMS):
                return None
            bias_hcd, beta_hcd = self._hcd_bias_beta(params)
            b_terms.append((bias_hcd, 'hcd'))
            bb_terms.append((bias_hcd * beta_hcd, 'hcd'))
        return ([(c, key, 0) for c, key in b_terms]
                + [(c, key, 2) for c, key in bb_terms])

    def _kaiser_product_terms(self, params, sampling=None):
        """The Kaiser factor as merged [(coeff, (key1, key2, mupow))]
        product terms, in the order of vega_tpu/power_spectrum.py:377-421:
        the coefficient of the basis grid key1 x key2 x mu_k^mupow. Reads
        no grid. None when not decomposable (`_tracer_poly_terms`)."""
        bias1, beta1, bias2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)
        t1 = self._tracer_poly_terms(params, self.tracer1_name, bias1, beta1,
                                     sampling)
        t2 = self._tracer_poly_terms(params, self.tracer2_name, bias2, beta2,
                                     sampling)
        if t1 is None or t2 is None:
            return None
        merged = {}
        for c1, k1, p1 in t1:
            for c2, k2, p2 in t2:
                key = (tuple(sorted([repr(k1), repr(k2)])), p1 + p2)
                coeff = c1 * c2
                if key in merged:
                    merged[key] = (merged[key][0] + coeff, merged[key][1])
                else:
                    merged[key] = (coeff, (k1, k2, p1 + p2))
        return list(merged.values())

    def _kaiser_basis_grids(self, keys, params):
        """The (mu_k, k) basis grid of each (key1, key2, mupow), built as
        vega_tpu/power_spectrum.py:399-420 builds them: mu_k^mupow times
        the grid of each key that is not 'one'."""
        hcd = None
        if any('hcd' in key[:2] for key in keys):
            hcd = self._hcd_profile(params)
        grids = []
        for k1, k2, mupow in keys:
            grid = self._mu_pow_grids[mupow] if mupow else None
            for k in (k1, k2):
                g = hcd if k == 'hcd' else (
                    self._uv_basis_grid(*k[1:]) if isinstance(k, tuple)
                    else None)
                if g is not None:
                    grid = g if grid is None else grid * g
            grids.append(self._mu_pow_grids[0] if grid is None else grid)
        return grids

    def _uv_basis_grid(self, lam, b_prim):
        """w / (1 + b_prim w) with w(k) = arctan(k lambda) / (k lambda)
        on the (mu_k, k) grid, built on the host in f64 as
        vega_tpu/power_spectrum.py:370-374 builds it."""
        w_k = np.arctan(self.k_grid * lam) / (self.k_grid * lam)
        return to_tensor(w_k / (1 + b_prim * w_k)
                         * np.ones_like(self.muk_grid), self.device,
                         self.dtype)

    def kaiser_coefficients(self, params):
        """The coefficient part of the factored Kaiser term: floats or
        (B,) tensors, one per basis grid."""
        return [c for c, _ in self._kaiser_product_terms(params)]

    def compute_tracer_polys(self, params):
        """Per-tracer Kaiser polynomials T_i(mu_k) = u_i + v_i F_hcd, as
        [(u, v)] with u = b + b beta mu_k^2 and v = b_hcd + b_hcd beta_hcd
        mu_k^2 (None without HCD): (mu_k, 1) or (B, mu_k, 1) tensors. The
        HCD effective biases fold in without the beta_eff division, as in
        vega_tpu/power_spectrum.py:423-454 (there as b_eff + bb_eff mu_k^2
        with both grids written out; here regrouped around the one
        (mu_k, k) grid F_hcd, so a batched row costs one pass over its
        grid, not six). Both tracers of an auto-correlation share one
        pair."""
        bias1, beta1, bias2, beta2 = utils.bias_beta(
            params, self.tracer1_name, self.tracer2_name)
        muk2 = self._muk_t ** 2
        polys = []
        for name, bias, beta in ((self.tracer1_name, bias1, beta1),
                                 (self.tracer2_name, bias2, beta2)):
            if polys and name == self.tracer1_name:
                polys.append(polys[0])
                continue
            b_eff = col(bias, 2)
            if (self._add_uvb or self._add_heii) and name == 'LYA':
                # UV / HeII shift the bias alone: bias * beta is invariant
                # (vega_tpu/power_spectrum.py:439-442)
                b_eff = self._uv_heii_bias(bias, params)
            u = b_eff + col(bias * beta, 2) * muk2
            v = None
            if self.hcd_model is not None and name == 'LYA':
                bias_hcd, beta_hcd = self._hcd_bias_beta(params)
                v = col(bias_hcd, 2) + col(bias_hcd * beta_hcd, 2) * muk2
            polys.append((u, v))
        return polys

    def compute_kaiser_poly(self, params):
        """Kaiser factor T_1 T_2 from the division-free tracer
        polynomials: (mu_k, 1) or (B, mu_k, 1), and a full (mu_k, k) or
        (B, mu_k, k) grid with HCD (vega_tpu/power_spectrum.py:456-460)."""
        polys = self.compute_tracer_polys(params)
        f_hcd = None
        if any(v is not None for _, v in polys):
            f_hcd = self._hcd_profile(params)
        terms = [u if v is None else torch.addcmul(u, v, f_hcd)
                 for u, v in polys[:1 if polys[1] is polys[0] else 2]]
        return terms[0] * terms[-1]

    def compute_kaiser(self, bias1, beta1, bias2, beta2, fast_metals=False):
        """Kaiser term (vega_tpu/power_spectrum.py:540-546); biases and
        betas floats, (B,) tensors or the HCD grids."""
        muk2 = self._muk_t ** 2
        pk = (1 + col(beta1, 2) * muk2) * (1 + col(beta2, 2) * muk2)
        if not fast_metals:
            pk = pk * col(bias1 * bias2, 2)
        return pk

    def _uv_heii_bias(self, bias, params):
        """bias + b_gamma w / (1 + b_prim w), w(k) = arctan(k lambda) /
        (k lambda), of the UV fluctuations, then + the same term of HeII
        reionization (b_gamma_e, lambda_HeII), added in
        vega_tpu/power_spectrum.py:548-563's order: (1, k), or (B, 1, k)
        for a batched parameter or bias."""
        k = self._k_t[None, :]
        bias_eff = col(bias, 2)
        for on, lam_name, gamma_name in (
                (self._add_uvb, 'lambda_uv', 'bias_gamma'),
                (self._add_heii, 'lambda_HeII', 'bias_gamma_e')):
            if on:
                lam = col(params[lam_name], 2)
                w_k = torch.atan(k * lam) / (k * lam)
                bias_eff = bias_eff + col(params[gamma_name], 2) * w_k / (
                    1 + col(params['bias_prim'], 2) * w_k)
        return bias_eff

    def compute_bias_beta_uv_heii(self, bias, beta, params):
        """UV fluctuations and HeII reionization effective biases
        (vega_tpu/power_spectrum.py:548-565): `_uv_heii_bias` and
        beta_eff = beta bias / bias_eff, each (1, k) or (B, 1, k)."""
        bias_eff = self._uv_heii_bias(bias, params)
        return bias_eff, col(beta, 2) * col(bias, 2) / bias_eff

    def compute_bias_beta_hcd(self, bias, beta, params):
        """HCD effective biases as (mu_k, k) grids
        (vega_tpu/power_spectrum.py:567-580)."""
        bias_hcd, beta_hcd = self._hcd_bias_beta(params)
        f_hcd = self._hcd_profile(params)
        bias_eff = col(bias, 2) + col(bias_hcd, 2) * f_hcd
        beta_eff = (col(bias * beta, 2)
                    + col(bias_hcd * beta_hcd, 2) * f_hcd) / bias_eff
        return bias_eff, beta_eff

    def _hcd_profile(self, params):
        """The HCD suppression profile F(k_par) on the grid
        (vega_tpu/power_spectrum.py:582-599)."""
        if 'Rogers' in self.hcd_model:
            # Fourier transform of a Lorentzian profile (Rogers et al. 2018)
            return torch.exp(-col(params['L0_hcd'], 2) * self.k_par_grid)
        if 'fvoigt' in self.hcd_model:
            return utils.interp(
                col(params.get('L0_fvoigt', 1.), 2) * self.k_par_grid,
                *self._fvoigt, left=1., right=0.)
        return utils.sinc(self.k_par_grid * col(params.get('L0_sinc', 1.), 2))

    def compute_dnl_mcdonald(self):
        """McDonald 2003 non-linear term (vega_tpu/power_spectrum.py:
        618-625)."""
        if not self.tracer1_name == self.tracer2_name == 'LYA':
            raise ValueError('dnl_mcdonald is a model of the LYA '
                             'auto-correlation')
        k = self._k_t
        kvel = 1.22 * (1 + k / 0.923) ** 0.451
        dnl = ((k / 6.4) ** 0.569 - (k / 15.3) ** 2.01
               - (k * self._muk_t / kvel) ** 1.5)
        return torch.exp(dnl)

    def compute_dnl_arinyo(self, params):
        """Arinyo et al. 2015 non-linear term; returns (dnl, bad), bad
        (B',) where the term is not finite (vega_tpu/power_spectrum.py:
        627-651)."""
        two_lya = 'LY' in self.tracer1_name and 'LY' in self.tracer2_name
        one_lya = 'LY' in self.tracer1_name or 'LY' in self.tracer2_name

        q1 = col(params['dnl_arinyo_q1'], 2)
        kv = col(params['dnl_arinyo_kv'], 2)
        av = col(params['dnl_arinyo_av'], 2)
        bv = col(params['dnl_arinyo_bv'], 2)
        kp = col(params['dnl_arinyo_kp'], 2)
        q2 = col(params.get('dnl_arinyo_q2', 0.), 2)

        k = self._k_t
        growth = q1 * self._delta_sq + q2 * self._delta_sq ** 2
        pec_velocity = (k / kv) ** av * torch.abs(self._muk_t) ** bv
        pressure = (k / kp) * (k / kp)
        dnl = torch.exp(growth * (1 - pec_velocity) - pressure)

        bad = ~torch.isfinite(dnl).reshape(
            (-1,) + dnl.shape[-2:]).all(dim=-1).all(dim=-1)
        if two_lya:
            return dnl, bad
        if one_lya:
            return torch.sqrt(dnl), bad
        return torch.ones_like(dnl), False

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

    def _compute_mock_binsize_gk(self, params):
        """The mock pixelization window sinc x sinc of `mock-bin-size`,
        along the line of sight scaled by `mock-los-smoothing` (growth,
        amplitude) or alone (only-los) (vega_tpu/power_spectrum.py:
        670-686)."""
        bin_size = self.mock_bin_size
        par_size, per_size = bin_size, bin_size
        los = self.mock_los_smoothing
        if los == 'growth':
            par_size = bin_size * (1 + params['growth_rate'])
        elif los == 'amplitude':
            par_size = bin_size * (1 + params['los_smooth_amp'])
        elif los == 'only-los':
            per_size = 0.
        elif los is not None:
            raise ValueError(f'Unknown mock LOS smoothing option {los}.')
        gk = utils.sinc(self.k_par_grid * col(par_size, 2) / 2)
        if not (isinstance(per_size, float) and per_size == 0):
            gk = gk * utils.sinc(self.k_trans_grid * col(per_size, 2) / 2)
        return gk

    def _gauss(self, sigma_par, sigma_trans):
        """exp(-(k_par^2 s_par^2 + k_trans^2 s_trans^2) / 2)."""
        return torch.exp(-(self.k_par_grid ** 2 * col(sigma_par, 2) ** 2
                           + self.k_trans_grid ** 2
                           * col(sigma_trans, 2) ** 2) / 2)

    def compute_fullshape_gauss_smoothing(self, params):
        """Full-shape Gaussian smoothing (vega_tpu/power_spectrum.py:
        688-721): the squared Gaussian of the global `par / per_sigma_
        smooth` (one of them standing for both), else of `par / per_
        sigma_smooth_metals` for a pair that is not LYA / QSO on both
        sides, else the product of each tracer's own Gaussian."""
        check1 = self.tracer1_name in ['LYA', 'QSO']
        check2 = self.tracer2_name in ['LYA', 'QSO']
        if 'par_sigma_smooth' in params or 'per_sigma_smooth' in params:
            sigma_par = params.get('par_sigma_smooth', None)
            sigma_trans = params.get('per_sigma_smooth', None)
            if sigma_par is None and sigma_trans is None:
                raise ValueError(
                    'Fullshape gaussian smoothing requested without '
                    'par_sigma_smooth and/or per_sigma_smooth.')
            if sigma_par is None:
                sigma_par = sigma_trans
            if sigma_trans is None:
                sigma_trans = sigma_par
            return self._gauss(sigma_par, sigma_trans) ** 2
        if ('par_sigma_smooth_metals' in params
                and 'per_sigma_smooth_metals' in params
                and not (check1 and check2)):
            return self._gauss(params['par_sigma_smooth_metals'],
                               params['per_sigma_smooth_metals']) ** 2
        return (self._gauss(params[f'par_sigma_smooth_{self.tracer1_name}'],
                            params[f'per_sigma_smooth_{self.tracer1_name}'])
                * self._gauss(
                    params[f'par_sigma_smooth_{self.tracer2_name}'],
                    params[f'per_sigma_smooth_{self.tracer2_name}']))

    def compute_fullshape_exp_smoothing(self, params):
        """Gaussian times exponential smoothing
        (vega_tpu/power_spectrum.py:723-730)."""
        gauss_sm = (self.k_par_grid ** 2
                    * col(params['par_sigma_smooth'], 2) ** 2
                    + self.k_trans_grid ** 2
                    * col(params['per_sigma_smooth'], 2) ** 2)
        exp_sm = (torch.abs(self.k_par_grid)
                  * col(params['par_exp_smooth'], 2) ** 2
                  + torch.abs(self.k_trans_grid)
                  * col(params['per_exp_smooth'], 2) ** 2)
        return torch.exp(-gauss_sm / 2) * torch.exp(-exp_sm)

    def compute_velocity_dispersion_gauss(self, params):
        """Gaussian velocity dispersion (vega_tpu/power_spectrum.py:
        732-745)."""
        if 'discrete' not in (self.tracer1_type, self.tracer2_type):
            raise ValueError('Velocity dispersion needs a discrete tracer')
        smoothing = 1.
        for name, kind in ((self.tracer1_name, self.tracer1_type),
                           (self.tracer2_name, self.tracer2_type)):
            if kind == 'discrete':
                sigma = col(params['sigma_velo_disp_gauss_' + name], 2)
                smoothing = smoothing * torch.exp(
                    -0.25 * (self.k_par_grid * sigma) ** 2)
        return smoothing * torch.ones_like(self.k_par_grid)

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
