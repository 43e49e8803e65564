"""Correlation-function (xi-space) model for one tracer pair.

Counterpart of vega_tpu/correlation_func.py: the AP coordinate rescaling
and Hankel transform (`compute_core`, `_rescale_coords`, :175-221;
single_multipole transforms one multipole alone), the bias redshift
evolution (:225-290: the mean power law, the split ("new") evolution of
a cross with the data file's cosmology, Croom's QSO model), the growth
factor (:290-307, or the legacy 100-point integration of
old_growth_func, :309-331), dense and factored (`compute`, :97-171),
the QSO radiation of the cross (`compute_qso_radiation`, :336-364;
factored as one term whose coefficient is its strength), the
relativistic and standard-asymmetry terms of the cross (:365-390, through
PktoXi's legacy combine; either densifies the model, as there), the UV
shotnoise (:148-171,413-454; factored as one term whose coefficient is
bias_gamma^2 uv_shotnoise_amp, unless lambda_uv is sampled) and the
template of the DESI instrumental systematics (:389-415), which model.py
adds. Host quantities are computed at init with numpy and kept as device
tensors.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.interpolate import interp1d
from scipy.special import expn

from .cosmo import growth_function
from .factored import FactoredXi, RecordingParams, Sampling, densify
from .utils import col, find_file, interp, to_tensor

# the instrumental systematics' amplitude when the parameters carry none
# (vega_tpu/correlation_func.py:414)
DESI_INST_SYS_AMP = 0.0003189935987295203


def compute_shotnoise_A(ntau=100, nrho=10000):
    """A(tau) of the UV shotnoise, Eq. 19 of Gontcho A Gontcho et al.
    (1404.7425), on the host (vega_tpu/correlation_func.py:419-433):
    (tau, A) on 100 points of [0.01, 5]."""
    tau = np.linspace(0.01, 5, ntau)
    rho = np.linspace(0.0001, 10, nrho)
    drho = rho[1] - rho[0]
    a_vals = np.zeros(tau.size)
    for i, t in enumerate(tau):
        a_vals[i] = -np.sum(
            drho * np.exp(-rho) / rho * (
                expn(1, rho * np.sqrt(1 + (t / rho) ** 2))
                - expn(1, rho * np.abs(1 - t / rho))))
    return tau, a_vals


def compute_growth_old(z_grid, z_fid, Omega_m, Omega_de):
    """The deprecated growth factor squared, D(z) from a 100-point
    integration on [0, 5] interpolated linearly, on the host
    (vega_tpu/correlation_func.py:309-331, kept for the DR16
    configurations that set old_growth_func)."""
    from scipy.integrate import quad

    def hubble(z):
        return np.sqrt(Omega_m * (1 + z) ** 3 + Omega_de
                       + (1 - Omega_m - Omega_de) * (1 + z) ** 2)

    def dD1(a):
        z = 1 / a - 1
        return 1. / (a * hubble(z)) ** 3

    nbins, zmax = 100, 5.
    z = zmax * np.arange(nbins, dtype=float) / (nbins - 1)
    d1 = np.zeros(nbins)
    for i in range(nbins):
        a = 1 / (1 + z[i])
        d1[i] = 2.5 * Omega_m * hubble(z[i]) * quad(dD1, 0, a)[0]
    d1_interp = interp1d(z, d1)
    growth = d1_interp(z_grid) / d1_interp(z_fid)
    return growth ** 2


class CorrelationFunction:
    """xi-space model (reference: correlation_func.py:10-115)."""

    def __init__(self, config, fiducial, coordinates, scale_params,
                 tracer1, tracer2, device, metal_corr=False,
                 dtype=torch.float64, cosmo=None):
        self.device = torch.device(device)
        self.dtype = dtype
        self._config = config
        self._z = coordinates.z_grid
        # the host grids stay f64 (vega_tpu's host work reads them)
        self._r_host = np.asarray(coordinates.r_grid, dtype=np.float64)
        self._mu_host = np.asarray(coordinates.mu_grid, dtype=np.float64)
        self._r = to_tensor(self._r_host, self.device, dtype)
        self._mu = to_tensor(self._mu_host, self.device, dtype)
        self._tracer1 = tracer1
        self._tracer2 = tracer2
        self._corr_name = f'{tracer1["name"]}x{tracer2["name"]}'
        self._scale_params = scale_params
        # a metal correlation: ap = at = 1 unless metal-scaling
        self._metal_corr = metal_corr
        self._multipole = config.getint('single_multipole', -1)

        # relativistic effects and standard asymmetry
        # (vega_tpu/correlation_func.py:73-81)
        self.relativistic_flag = config.getboolean('relativistic correction',
                                                   False)
        self.asymmetry_flag = config.getboolean('standard asymmetry', False)
        if self.relativistic_flag or self.asymmetry_flag:
            types = [tracer1['type'], tracer2['type']]
            if ('continuous' not in types) or (types[0] == types[1]):
                raise ValueError('Relativistic effects and standard '
                                 'asymmetry only work for the cross')
        # the UV shotnoise's A(tau) table (vega_tpu/correlation_func.py:
        # 83-89), interpolated on the device
        self.uv_shotnoise_flag = config.getboolean('UVB-shotnoise', False)
        self._uv_table = None
        if self.uv_shotnoise_flag:
            self._uv_table = tuple(to_tensor(a, self.device, dtype)
                                   for a in compute_shotnoise_A())
        self._croom = {name: 'croom' in self._evol_model(name)
                       for name in (tracer1['name'], tracer2['name'])}
        # QSO radiation (vega_tpu/correlation_func.py:66-71)
        self.radiation_flag = config.getboolean('radiation effects', False)
        if self.radiation_flag:
            names = [tracer1['name'], tracer2['name']]
            if not ('QSO' in names and 'LYA' in names):
                raise ValueError('QSO radiation effects only apply to the '
                                 'cross (QSOxLya)')
        self._rescale_coords_systematics = config.getboolean(
            'rescale-coords-systematics', False)

        # delta rp only for the cross (reference: correlation_func.py:64-69)
        self._delta_rp_name = None
        if tracer1['type'] == 'discrete' and tracer2['type'] != 'discrete':
            self._delta_rp_name = 'drp_' + tracer1['name']
        elif tracer2['type'] == 'discrete' and tracer1['type'] != 'discrete':
            self._delta_rp_name = 'drp_' + tracer2['name']

        # Growth factor on the static z grid
        # (vega_tpu/correlation_func.py:290-307)
        self._z_fid = fiducial['z_fiducial']
        self._Omega_m = fiducial.get('Omega_m', None)
        self._Omega_de = fiducial.get('Omega_de', None)
        if config.getboolean('old_growth_func', False):
            growth = compute_growth_old(self._z, self._z_fid, self._Omega_m,
                                        self._Omega_de)
        else:
            growth = self.compute_growth()
        self._z_eff = fiducial['z_eff']
        self._z_t = to_tensor(self._z, self.device, dtype)
        self.xi_growth = to_tensor(growth, self.device, dtype)
        self.init_bias_evol(tracer1['type'], tracer2['type'], cosmo)

    def set_constants(self, xi_growth, rel_z_evol):
        """Install the host growth and z-evolution arrays as tensors."""
        self.xi_growth = to_tensor(xi_growth, self.device, self.dtype)
        self._rel_z_evol = to_tensor(rel_z_evol, self.device, self.dtype)

    def init_bias_evol(self, type1, type2, cosmo=None):
        """The relative z-evolution bases (vega_tpu/correlation_func.py:
        226-248): the mean one, (1 + z) / (1 + z_eff), and with
        new-bias-evolution for tracers of two types the split one: the
        quasar's and the forest's redshifts z -/+ rp / (2 D_H(z)) in the
        data file's cosmology, each tracer's relative evolution at its
        own. Without a cosmology the mean evolution serves, with
        vega_tpu's warning."""
        self._rel_z_evol = to_tensor(
            (1. + np.asarray(self._z)) / (1 + self._z_eff), self.device,
            self.dtype)
        self._split_evol = None
        kinds = (type1, type2)
        if (not self._config.getboolean('new-bias-evolution', False)
                or kinds[0] == kinds[1]):
            return
        if cosmo is None:
            print('Warning: No cosmology found in xcf files, '
                  'using mean redshift evolution.')
            return
        z = np.asarray(self._z)
        rp = self._r_host * self._mu_host
        dist_hubble = cosmo.get_dist_hubble(z)
        z_q = z - rp / (2 * dist_hubble)
        z_f = z + rp / (2 * dist_hubble)
        self._split_evol = tuple(
            to_tensor((1. + (z_q if kind == 'discrete' else z_f))
                      / (1 + self._z_eff), self.device, self.dtype)
            for kind in kinds)

    def _evol_model(self, tracer_name):
        handle_name = f'z evol {tracer_name}'
        if handle_name in self._config:
            return self._config.get(handle_name, 'standard')
        return self._config.get('z evol', 'standard')

    # ------------------------------------------------------------------
    def compute(self, pk, pktoxi_obj, params, use_kernel=True,
                sampling=None, pk_lin=None):
        """xi model for the input P(k); returns (xi, bad_flag)
        (vega_tpu/correlation_func.py:97-171). A FactoredXi from the
        transform stays factored unless the z-evolution read a sampled
        name (`sampling`), which densifies it first. The QSO radiation
        (smooth component only) is a term of its own whose coefficient
        is its strength, unless its shape read a sampled name. The
        relativistic and asymmetry terms read the (n_k,) linear spectrum
        `pk_lin` and densify the model; the UV shotnoise (both
        components) is a term whose coefficient is b_gamma^2 times its
        amplitude unless lambda_uv is sampled."""
        xi, rescaled_r, rescaled_mu, bad = self.compute_core(
            pk, pktoxi_obj, params, use_kernel, sampling)
        rec = RecordingParams(params, sampling)
        evol = self.compute_bias_evol(rec)
        if isinstance(xi, FactoredXi) and rec.traced():
            xi = xi.dense()
        if isinstance(xi, FactoredXi):
            xi = xi.mul_vec(evol * self.xi_growth)
        else:
            xi = xi * evol
            xi = xi * self.xi_growth

        if self.radiation_flag and not params['peak']:
            if isinstance(xi, FactoredXi):
                # the shape at unit strength: read by name, the strength
                # is not one of the names it depends on
                rad_pars = dict(params)
                rad_pars['qso_rad_strength'] = 1.0
                rec_rad = RecordingParams(rad_pars, None if sampling is None
                                          else Sampling(
                    sampling.sampled - {'qso_rad_strength'}, sampling.grid))
                shape = self.compute_qso_radiation(rec_rad, rescaled_r,
                                                   rescaled_mu)
                if rec_rad.traced():
                    xi = (xi.dense()
                          + col(params['qso_rad_strength'], 1) * shape)
                else:
                    xi = xi.add_vec(shape, coeff=params['qso_rad_strength'])
            else:
                xi = xi + self.compute_qso_radiation(params, rescaled_r,
                                                     rescaled_mu)

        for on, term in ((self.relativistic_flag,
                          pktoxi_obj.pk_to_xi_relativistic),
                         (self.asymmetry_flag, pktoxi_obj.pk_to_xi_asymmetry)):
            if on:
                xi = densify(xi) + self._legacy_term(term, pk_lin, params,
                                                     use_kernel)

        if self.uv_shotnoise_flag:
            if isinstance(xi, FactoredXi) and not sampling.traced(
                    'lambda_uv'):
                lam = params['lambda_uv']
                xi = xi.add_vec(self._uv_shotnoise_shape(
                    lam, rescaled_r, rescaled_mu),
                    coeff=self._uv_shotnoise_amp(params))
            else:
                xi = densify(xi) + self.compute_uv_shotnoise(
                    params, rescaled_r, rescaled_mu)
        return xi, bad

    def _legacy_term(self, term, pk_lin, params, use_kernel):
        """The relativistic or asymmetry term at the coordinates rescaled
        without the correlation's own ap / at names
        (vega_tpu/correlation_func.py:365-390 call get_ap_at without
        corr_name)."""
        delta_rp = params.get(self._delta_rp_name, 0.)
        ap, at = self._scale_params.get_ap_at(params,
                                              metal_corr=self._metal_corr)
        rescaled_r, rescaled_mu = self._rescale_coords(
            self._r, self._mu, col(ap, 1), col(at, 1), col(delta_rp, 1))
        return term(rescaled_r, rescaled_mu, pk_lin, params, use_kernel)

    def shotnoise_coefficients(self, params):
        """The coefficient of the term `compute` appends to each
        component's factored transform for the UV shotnoise: [b_gamma^2
        uv_shotnoise_amp], or []."""
        return ([self._uv_shotnoise_amp(params)] if self.uv_shotnoise_flag
                else [])

    @staticmethod
    def _uv_shotnoise_amp(params):
        """bias_gamma^2 (or bias_gamma_e^2) x uv_shotnoise_amp."""
        if 'bias_gamma' in params:
            bias_gamma = params['bias_gamma']
        elif 'bias_gamma_e' in params:
            bias_gamma = params['bias_gamma_e']
        else:
            raise ValueError('UV shotnoise requested but bias_gamma or '
                             'bias_gamma_e is not in the parameters.')
        return bias_gamma ** 2 * params['uv_shotnoise_amp']

    def _uv_shotnoise_shape(self, lam, rescaled_r, rescaled_mu):
        """lambda / r A(r / lambda) at the data's r, or with
        rescale-coords-systematics at sqrt(r'^2 + mu'^2) of the rescaled
        coordinates (vega_tpu/correlation_func.py:437-454); A read
        linearly off its table, A[0] below it and 0 above."""
        if self._rescale_coords_systematics:
            r = torch.sqrt(rescaled_r ** 2 + rescaled_mu ** 2)
        else:
            r = self._r
        lam = col(lam, 1)
        tau, a_vals = self._uv_table
        return lam / r * interp(r / lam, tau, a_vals, left=a_vals[0],
                                right=0.)

    def compute_uv_shotnoise(self, params, rescaled_r, rescaled_mu):
        """The UV shotnoise term (vega_tpu/correlation_func.py:437-454)."""
        return col(self._uv_shotnoise_amp(params), 1) * \
            self._uv_shotnoise_shape(params['lambda_uv'], rescaled_r,
                                     rescaled_mu)

    def radiation_coefficients(self, params):
        """The coefficient of the term `compute` appends to the smooth
        component's factored transform: [the radiation strength], or []."""
        return [params['qso_rad_strength']] if self.radiation_flag else []

    def compute_core(self, pk, pktoxi_obj, params, use_kernel=True,
                     sampling=None):
        """Hankel transform at the AP-rescaled coordinates
        (vega_tpu/correlation_func.py:175-198): (xi, rescaled r,
        rescaled mu, bad). The coordinates count as parameter-free when
        the rescaling read no sampled name other than a grid parameter."""
        rec = RecordingParams(params, sampling)
        delta_rp = 0.
        if self._delta_rp_name is not None:
            delta_rp = rec.get(self._delta_rp_name, 0.)
        ap, at = self._scale_params.get_ap_at(
            rec, corr_name=self._corr_name, metal_corr=self._metal_corr)
        rescaled_r, rescaled_mu = self._rescale_coords(
            self._r, self._mu, col(ap, 1), col(at, 1), col(delta_rp, 1))
        xi, bad = pktoxi_obj.compute(rescaled_r, rescaled_mu, pk,
                                     use_kernel=use_kernel,
                                     coords_param_free=not rec.traced(),
                                     single_ell=self._multipole)
        return xi, rescaled_r, rescaled_mu, bad

    @staticmethod
    def _rescale_coords(r, mu, ap, at, delta_rp=0.):
        """AP rescaling (vega_tpu/correlation_func.py:200-221);
        branchless at r = 0."""
        mask = r != 0
        rp = r * mu + delta_rp * mask.to(r.dtype)   # bool * float is f32
        rt = r * torch.sqrt(1 - mu ** 2)
        rescaled_rp = ap * rp
        rescaled_rt = at * rt
        sq = rescaled_rp ** 2 + rescaled_rt ** 2
        pos = mask & (sq > 0)
        rescaled_r = torch.sqrt(torch.where(pos, sq, 1.0))
        rescaled_mu = (torch.where(pos, rescaled_rp, 0.0)
                       / torch.where(pos, rescaled_r, 1.0))
        return torch.where(pos, rescaled_r, 0.0), rescaled_mu

    def compute_bias_evol(self, params):
        """The product of both tracers' bias evolutions
        (vega_tpu/correlation_func.py:250-290): Croom's QSO model where
        the tracer's `z evol` names it, else the (1+z)^alpha power law of
        the mean redshift, or of each tracer's own with the split
        evolution."""
        rels = self._split_evol or (self._rel_z_evol, self._rel_z_evol)
        evol = None
        for tracer, rel in zip((self._tracer1, self._tracer2), rels):
            name = tracer['name']
            if self._croom[name]:
                if self._split_evol is not None:
                    raise AssertionError(
                        'Croom model is not supported with new bias evol')
                factor = self._bias_evol_croom(params, name)
            else:
                factor = rel ** col(params[f'alpha_{name}'], 1)
            evol = factor if evol is None else evol * factor
        return evol

    def _bias_evol_croom(self, params, tracer_name):
        """Croom et al. 2005's QSO bias evolution
        (vega_tpu/correlation_func.py:280-288)."""
        if tracer_name != 'QSO':
            raise AssertionError('the Croom model is a QSO model')
        p0 = col(params['croom_par0'], 1)
        p1 = col(params['croom_par1'], 1)
        return ((p0 + p1 * (1. + self._z_t) ** 2)
                / (p0 + p1 * (1 + self._z_eff) ** 2))

    # ------------------------------------------------------------------
    # Additive terms
    # ------------------------------------------------------------------
    def compute_qso_radiation(self, params, rescaled_r, rescaled_mu):
        """QSO transverse proximity effect
        (vega_tpu/correlation_func.py:336-364): (M,) or (B, M)."""
        delta_rp = col(params.get(self._delta_rp_name, 0.), 1)
        if self._rescale_coords_systematics:
            rp = rescaled_r * rescaled_mu + delta_rp
            rt = rescaled_r * torch.sqrt(1 - rescaled_mu ** 2)
        else:
            rp = self._r * self._mu + delta_rp
            rt = self._r * torch.sqrt(1 - self._mu ** 2)

        r_shift = torch.sqrt(rp ** 2 + rt ** 2)
        r_safe = torch.where(r_shift != 0, r_shift, 1.0)
        mu_shift = rp / r_safe

        strength = col(params['qso_rad_strength'], 1)
        asymmetry = col(params['qso_rad_asymmetry'], 1)
        lifetime = col(params['qso_rad_lifetime'], 1)
        decrease = col(params['qso_rad_decrease'], 1)

        xi_rad = strength / (r_safe ** 2) * (
            1 - asymmetry * (1 - mu_shift ** 2))
        return xi_rad * torch.exp(
            -r_shift * ((1 + mu_shift) / lifetime + 1 / decrease))

    def desi_instrumental_systematics_template(self, bin_size_rp):
        """The fiber-positioner sky-noise correlation at unit amplitude,
        (M,) host numpy, built once on the host
        (vega_tpu/correlation_func.py:389-415): the tabulated xi(rt) in
        the first rp bin, zero elsewhere."""
        if self._tracer1['type'] != self._tracer2['type']:
            raise ValueError('DESI instrumental systematics model only '
                             'applies to auto-correlation functions.')
        r, mu = self._r_host, self._mu_host
        rp = r * mu
        rt = r * np.sqrt(1 - mu ** 2)
        w = (rp > 0) & (rp < bin_size_rp)
        table = np.genfromtxt(
            find_file('instrumental_systematics/'
                      'desi-instrument-syst-for-forest-auto-correlation.csv'),
            delimiter=',', names=True)
        interp = interp1d(table['RT'], table['XI'], kind='linear')
        template = np.zeros(rt.shape)
        template[w] = interp(rt[w])
        return template

    # ------------------------------------------------------------------
    # vega_tpu's reference-named views (vega_tpu/correlation_func.py:
    # 290-436): the terms `compute` assembles, one at a time
    # ------------------------------------------------------------------
    def compute_growth(self, z_grid=None, z_fid=None, Omega_m=None,
                       Omega_de=None):
        """D(z)^2 / D(z_fid)^2 on the host (vega_tpu/correlation_func.py:
        290-307); without Omega_de the (1 + z_fid) / (1 + z) scaling."""
        z_grid = self._z if z_grid is None else z_grid
        z_fid = self._z_fid if z_fid is None else z_fid
        Omega_m = self._Omega_m if Omega_m is None else Omega_m
        Omega_de = self._Omega_de if Omega_de is None else Omega_de
        if Omega_de is None:
            return ((1 + z_fid) / (1. + np.asarray(z_grid))) ** 2
        return (growth_function(z_grid, Omega_m, Omega_de)
                / growth_function(z_fid, Omega_m, Omega_de)) ** 2

    def _check_cross_term(self):
        types = (self._tracer1['type'], self._tracer2['type'])
        if 'continuous' not in types or types[0] == types[1]:
            raise AssertionError('the relativistic and asymmetry terms '
                                 'are terms of the cross')

    def compute_xi_relativistic(self, pk, pktoxi_obj, params,
                                use_kernel=True):
        """The relativistic term of the (n_k,) linear spectrum `pk`
        (vega_tpu/correlation_func.py:365-375)."""
        self._check_cross_term()
        return self._legacy_term(pktoxi_obj.pk_to_xi_relativistic, pk,
                                 params, use_kernel)

    def compute_xi_asymmetry(self, pk, pktoxi_obj, params, use_kernel=True):
        """The standard-asymmetry term of the (n_k,) linear spectrum `pk`
        (vega_tpu/correlation_func.py:377-387)."""
        self._check_cross_term()
        return self._legacy_term(pktoxi_obj.pk_to_xi_asymmetry, pk, params,
                                 use_kernel)

    def compute_desi_instrumental_systematics(self, params, bin_size_rp):
        """amplitude x the template (vega_tpu/correlation_func.py:389-414),
        the amplitude DESI_INST_SYS_AMP when the parameters carry none."""
        template = to_tensor(
            self.desi_instrumental_systematics_template(bin_size_rp),
            self.device, self.dtype)
        return col(params.get('desi_inst_sys_amp', DESI_INST_SYS_AMP),
                   1) * template

    compute_shotnoise_A = staticmethod(compute_shotnoise_A)

    def uv_A(self, tau):
        """A(tau) read linearly off its table, A[0] below it and 0 above
        (vega_tpu/correlation_func.py:430-436); the table is built here
        when the UV shotnoise is off."""
        if self._uv_table is None:
            self._uv_table = tuple(to_tensor(a, self.device, self.dtype)
                                   for a in compute_shotnoise_A())
        tab_tau, a_vals = self._uv_table
        tau = to_tensor(tau, self.device, self.dtype)
        return interp(tau.reshape(-1), tab_tau, a_vals, left=a_vals[0],
                      right=0.).reshape(tau.shape)
