"""Per-correlation model assembly: the peak/smooth decomposition and the
distortion matrix.

Counterpart of vega_tpu/model.py (`compute`, :211-245) with the metal
correlations (metals.py), the DESI instrumental systematics
(:84-86,136-148: amplitude x a static template on the smooth component)
and the broadband polynomials before and after the distortion
(:59-63,149-160,180-209). The distortion matrix, where the data carry one
that is not the identity, is a dense f64 matmul (vega_tpu/model.py:93-97,
152-157).

With a `Sampling` the model takes the factored path where it can and
returns a FactoredXi whose terms are the peak's then the smooth's, in
the order of vega_tpu's: per component the Kaiser terms, the QSO
radiation's (smooth), the metals', the instrumental systematics'
(smooth), the additive broadband's before the distortion, then after it;
`coefficients` is its coefficient part, run per evaluation on (B,)
tensors.

With save-components (the fiducial's 'save-components', set by [output]
write_pk / write_cf) a model keeps the components of the evaluations it
is asked to save (`compute(..., save=True)`, VegaInterface.compute_model
alone: one dense row) as host arrays, keyed as vega_tpu keys them
(vega_tpu/model.py:53-57,117-163): `pk`, `xi` and `xi_distorted`, each
{'peak': {}, 'smooth': {}, 'full': {}}, with the core model under
'core' and, with the metals decomposed (no-metal-decomp = False), each
metal pair's under its (name1, name2).

`compute_direct` is the model on one given linear spectrum, a single
component 'full' with no peak / smooth split (vega_tpu/model.py:247-251;
the Monte-Carlo fiducial of use_full_pk_for_mc). With `model_pk` (the
main [control] option) both return the power spectrum's multipoles (n_ell,
n_k) per row instead of the correlation (vega_tpu/model.py:110-111):
the Legendre projection, one GEMM.
"""

from __future__ import annotations

import numpy as np
import torch

from . import correlation_func as corr_func
from . import metals, pktoxi, power_spectrum
from .broadband_poly import BroadbandPolynomials
from .factored import FactoredXi, RecordingParams, densify, stack_coefficients
from .utils import col, host_row, to_tensor


class Model:
    """Correlation model for one component (reference: model.py:8-77)."""

    def __init__(self, corr_item, fiducial, scale_params, data=None, *,
                 device, dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        self._corr_item = corr_item
        self._model_pk = corr_item.model_pk
        if corr_item.model_coordinates is None:
            raise ValueError('CorrelationItem has no model coordinates')
        corr_item.config['model']['bin_size_rp'] = \
            str(corr_item.data_coordinates.rp_binsize)
        corr_item.config['model']['bin_size_rt'] = \
            str(corr_item.data_coordinates.rt_binsize)

        self.save_components = fiducial.get('save-components', False)
        if self.save_components:
            self.pk = {'peak': {}, 'smooth': {}, 'full': {}}
            self.xi = {'peak': {}, 'smooth': {}, 'full': {}}
            self.xi_distorted = {'peak': {}, 'smooth': {}, 'full': {}}

        self.broadband = None
        if 'broadband' in corr_item.config:
            self.broadband = BroadbandPolynomials(
                corr_item.config['broadband'], corr_item.name,
                corr_item.model_coordinates, corr_item.dist_model_coordinates,
                device=self.device, dtype=dtype)

        self.Pk_core = power_spectrum.PowerSpectrum(
            corr_item.config['model'], fiducial, corr_item.tracer1,
            corr_item.tracer2, corr_item.name, device=self.device,
            dtype=dtype)
        self.PktoXi = pktoxi.PktoXi.init_from_Pk(
            self.Pk_core, corr_item.config['model'])
        self.Xi_core = corr_func.CorrelationFunction(
            corr_item.config['model'], fiducial, corr_item.model_coordinates,
            scale_params, corr_item.tracer1, corr_item.tracer2,
            device=self.device, dtype=dtype, cosmo=corr_item.cosmo)

        # DESI instrumental systematics: amplitude x a template built
        # once on the host (vega_tpu/model.py:84-86)
        self._inst_sys_template = None
        if corr_item.config['model'].getboolean(
                'desi-instrumental-systematics', False):
            self._inst_sys_template = to_tensor(
                self.Xi_core.desi_instrumental_systematics_template(
                    corr_item.data_coordinates.rp_binsize), self.device,
                dtype)

        # Metals are added once to the smooth component, computed on the
        # full linear spectrum (no-metal-decomp, the default), or to each
        # component on its own spectrum
        self.metals = None
        if corr_item.has_metals:
            self.metals = metals.Metals(corr_item, fiducial, scale_params,
                                        data, device=self.device, dtype=dtype)
            self.no_metal_decomp = corr_item.config['model'].getboolean(
                'no-metal-decomp', True)

        # Dense distortion matrix; skipped when it is exactly the
        # identity (the data layer substitutes eye for an absent one)
        self._dist_mat = None
        if (corr_item.has_distortion and data is not None
                and data.has_distortion):
            dist = np.asarray(data.distortion_mat, dtype=np.float64)
            if not np.array_equal(dist, np.eye(*dist.shape)):
                self._dist_mat = to_tensor(dist, self.device, dtype)

    def _compute_model(self, pars, pk_model, use_kernel, sampling=None,
                       xi_metals=None, pk_lin=None, component=None):
        """One component's correlation function
        (vega_tpu/model.py:100-165): the core model, plus `xi_metals`
        when given (no-metal-decomp), else with metals the metal stack on
        this component's linear spectrum `pk_lin`. With `component`
        ('peak' or 'smooth') its components are saved."""
        xi_model, bad = self.Xi_core.compute(pk_model, self.PktoXi, pars,
                                             use_kernel, sampling, pk_lin)
        if component is not None:
            self.pk[component]['core'] = host_row(pk_model, 2)
            self.xi[component]['core'] = host_row(xi_model, 1)
        if self.metals is not None:
            if self.no_metal_decomp and xi_metals is not None:
                xi_model = self._add_xi(xi_model, xi_metals)
            elif not self.no_metal_decomp:
                xi_m, bad_m = self.metals.compute(pars, pk_lin, use_kernel,
                                                  sampling, component)
                xi_model = self._add_xi(xi_model, xi_m)
                bad = bad | bad_m
                if component is not None:
                    for mine, theirs in (
                            (self.pk, self.metals.pk),
                            (self.xi, self.metals.xi),
                            (self.xi_distorted, self.metals.xi_distorted)):
                        mine[component].update(theirs[component])
        if self._inst_sys_template is not None and not pars['peak']:
            # vega_tpu/model.py:136-148: the amplitude is the term's
            # coefficient; without the parameter the default amplitude
            # sits in the template
            coeff, vec = self._inst_sys_term(pars)
            if isinstance(xi_model, FactoredXi):
                xi_model = xi_model.add_vec(vec, coeff=coeff)
            else:
                xi_model = xi_model + col(coeff, 1) * vec
        if self.broadband is not None:
            xi_model = self._apply_broadband(xi_model, pars, 'pre', sampling)
        if self._dist_mat is not None:
            if isinstance(xi_model, FactoredXi):
                xi_model = xi_model.matmul(self._dist_mat)
            else:
                xi_model = xi_model @ self._dist_mat.T
        if self.broadband is not None:
            xi_model = self._apply_broadband(xi_model, pars, 'post',
                                             sampling)
        if component is not None:
            self.xi_distorted[component]['core'] = host_row(xi_model, 1)
        return xi_model, bad

    def _apply_broadband(self, xi_model, pars, position, sampling):
        """The multiplicative then the additive broadband of one position
        (vega_tpu/model.py:180-209). A factored xi stays factored: a
        multiplicative polynomial that read no sampled name scales the
        basis rows, the additive columns become terms. A sampled
        multiplicative coefficient densifies and applies both stages here;
        a sky term that read a sampled name densifies before the additive
        stage."""
        broadband = self.broadband
        if isinstance(xi_model, FactoredXi):
            rec = RecordingParams(pars, sampling)
            bb_mul = broadband.compute(rec, f'{position}-mul')
            if rec.traced():
                return (xi_model.dense() * bb_mul
                        + broadband.compute(pars, f'{position}-add'))
            if isinstance(bb_mul, torch.Tensor):
                xi_model = xi_model.mul_vec(bb_mul)
            terms = broadband.compute_add_terms(pars, position, sampling)
            if terms is None:
                return (xi_model.dense()
                        + broadband.compute(pars, f'{position}-add'))
            return xi_model.add_terms(terms)
        xi_model = xi_model * broadband.compute(pars, f'{position}-mul')
        return xi_model + broadband.compute(pars, f'{position}-add')

    def _inst_sys_term(self, pars):
        """(coefficient, template) of the instrumental systematics."""
        amp = pars.get('desi_inst_sys_amp', None)
        if amp is None:
            return 1.0, corr_func.DESI_INST_SYS_AMP * self._inst_sys_template
        return amp, self._inst_sys_template

    @staticmethod
    def _add_xi(a, b):
        """Add two xi values, keeping the factored form when both sides
        carry one; a mixed pair densifies the factored side
        (vega_tpu/model.py:167-178)."""
        if isinstance(a, FactoredXi) and isinstance(b, FactoredXi):
            return a + b
        return densify(a) + densify(b)

    def compute(self, pars, pk_full, pk_smooth, use_kernel=True,
                sampling=None, pk_cache=None, save=False):
        """Peak/smooth decomposition (vega_tpu/model.py:211-245).

        pars : dict of floats and (B,) tensors
        pk_full, pk_smooth : (n_k,) tensors
        sampling : a factored.Sampling for the factored path, or None
        pk_cache : a dict that keeps the factored power spectra (and their
            knot tables) and the factored metal stack between calls with
            the same sampled set, when no grid parameter shaped them (the
            grid sweep's node chunks)
        save : keep this evaluation's components when the model has
            save-components (one dense row: no `sampling`, B' = 1)
        Returns (xi_full, bad (B',)): xi_full is (B', M), B' = 1 when no
        parameter the model reads is batched, or a FactoredXi.
        """
        save = save and self.save_components
        if save and sampling is not None:
            raise ValueError('components are saved on the dense path only')
        pars = dict(pars)
        pars['peak'] = True
        pk_peak_lin = pk_full - pk_smooth
        if pk_cache is not None and 'pk' in pk_cache:
            pk_peak, pk_smooth_grid, bad_pk = pk_cache['pk']
        else:
            pk_peak, pk_smooth_grid, bad_pk = \
                self.Pk_core.compute_peak_smooth(pars, pk_peak_lin,
                                                 pk_smooth, sampling)
            if (pk_cache is not None
                    and isinstance(pk_peak, power_spectrum.FactoredPk)
                    and pk_peak.grid_free):
                pk_cache['pk'] = (pk_peak, pk_smooth_grid, bad_pk)
        if self._model_pk:
            # the multipoles of bao_amp x peak + smooth: vega_tpu's
            # _compute_model returns them before the transform, so no
            # metal and no term after it enters (model.py:110-111)
            return (col(pars['bao_amp'], 2)
                    * self.PktoXi.compute_pk_ells(pk_peak)
                    + self.PktoXi.compute_pk_ells(pk_smooth_grid), bad_pk)
        xi_peak, bad_peak = self._compute_model(
            pars, pk_peak, use_kernel, sampling, pk_lin=pk_peak_lin,
            component='peak' if save else None)
        del pk_peak

        pars['peak'] = False
        xi_metals, bad_metals = None, False
        if self.metals is not None and self.no_metal_decomp:
            if pk_cache is not None and 'metals' in pk_cache:
                xi_metals, bad_metals = pk_cache['metals']
            else:
                xi_metals, bad_metals = self.metals.compute(
                    pars, pk_full, use_kernel, sampling,
                    'full' if save else None)
                # basis rows without a leading axis: no grid parameter
                # moved them, every node chunk gets the same
                if (pk_cache is not None
                        and isinstance(xi_metals, FactoredXi)
                        and xi_metals.V.dim() == 2):
                    pk_cache['metals'] = (xi_metals, bad_metals)
        xi_smooth, bad_smooth = self._compute_model(
            pars, pk_smooth_grid, use_kernel, sampling, xi_metals=xi_metals,
            pk_lin=pk_smooth, component='smooth' if save else None)
        if isinstance(xi_peak, FactoredXi):
            xi_peak = xi_peak.scale(pars['bao_amp'])
        else:
            xi_peak = col(pars['bao_amp'], 1) * xi_peak
        return (self._add_xi(xi_peak, xi_smooth),
                bad_peak | bad_metals | bad_smooth | bad_pk)

    def compute_direct(self, pars, pk_full, use_kernel=True, save=False):
        """The model on the linear spectrum `pk_full` alone, one
        component 'full' with no peak / smooth split and no BAO
        broadening (vega_tpu/model.py:247-251): P(k, mu_k) from
        `PowerSpectrum.compute` with peak = False, then the transform
        (through the combine) and the terms after it. With the metals
        and no-metal-decomp (the default) no metal is added, as in
        vega_tpu, where only `compute` passes the metals in
        (model.py:124-126); with no-metal-decomp = False each metal pair
        is computed on `pk_full`. `save` keeps the components under
        'full'. Returns (xi (B', M), bad (B',)), or the multipoles
        (B', n_ell, n_k) under model_pk."""
        save = save and self.save_components
        pars = dict(pars)
        pars['peak'] = False
        pk_model, bad = self.Pk_core.compute(pk_full, pars)
        if self._model_pk:
            return self.PktoXi.compute_pk_ells(pk_model), bad
        xi, bad_xi = self._compute_model(
            pars, pk_model, use_kernel, pk_lin=pk_full,
            component='full' if save else None)
        return xi, bad_xi | bad

    def coefficients(self, pars, n_rows):
        """The coefficient part of the factored model: (n_rows, T), the
        peak's terms times bao_amp, then the smooth's, as `compute`
        orders them: each component's HCD- and UV-merged Kaiser
        coefficients, the QSO radiation's strength (smooth), the UV
        shotnoise's b_gamma^2 amplitude, the metals' weight x (1,
        b1 + b2, b1 b2) per pair (the smooth's alone with
        no-metal-decomp, both without), the instrumental systematics'
        amplitude (smooth), each component's additive broadband
        coefficients before, then after, the distortion. Reads only
        scalars and (B,) tensors."""
        kaiser = self.Pk_core.kaiser_coefficients(pars)
        shotnoise = self.Xi_core.shotnoise_coefficients(pars)
        metal = [] if self.metals is None else self.metals.coefficients(pars)
        peak = kaiser + shotnoise
        if self.metals is not None and not self.no_metal_decomp:
            peak = peak + metal
        smooth = (kaiser + self.Xi_core.radiation_coefficients(pars)
                  + shotnoise + metal)
        if self._inst_sys_template is not None:
            smooth.append(self._inst_sys_term(pars)[0])
        if self.broadband is not None:
            bb = (self.broadband.add_coefficients(pars, 'pre')
                  + self.broadband.add_coefficients(pars, 'post'))
            peak, smooth = peak + bb, smooth + bb
        coeffs = [pars['bao_amp'] * c for c in peak] + smooth
        return stack_coefficients(coeffs, self.Pk_core._muk_t).expand(
            n_rows, len(coeffs))
