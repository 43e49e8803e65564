"""Correlation-function (xi-space) model for one tracer pair.

Counterpart of vega_tpu/correlation_func.py: the AP coordinate rescaling
and Hankel transform (`compute_core`, `_rescale_coords`, :175-221), the
standard bias redshift evolution (:250-276, the mean evolution) and the
growth factor (:290-307), dense and factored (`compute`, :97-120). Host
quantities are computed at init with numpy and kept as device tensors;
the additive terms (QSO radiation, relativistic, asymmetry, UV
shotnoise, DESI instrumental systematics), single multipoles, the split
("new") and Croom bias evolutions are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .cosmo import growth_function
from .factored import FactoredXi, RecordingParams
from .utils import col, not_ported, to_tensor


class CorrelationFunction:
    """xi-space model (reference: correlation_func.py:10-115)."""

    def __init__(self, config, fiducial, coordinates, scale_params,
                 tracer1, tracer2, device, metal_corr=False):
        self.device = torch.device(device)
        self._config = config
        self._z = coordinates.z_grid
        self._r = to_tensor(coordinates.r_grid, self.device)
        self._mu = to_tensor(coordinates.mu_grid, self.device)
        self._tracer1 = tracer1
        self._tracer2 = tracer2
        self._corr_name = f'{tracer1["name"]}x{tracer2["name"]}'
        self._scale_params = scale_params
        # a metal correlation: ap = at = 1 unless metal-scaling
        self._metal_corr = metal_corr

        for option, feature in (
                ('radiation effects', 'QSO radiation'),
                ('relativistic correction', 'Relativistic correction'),
                ('standard asymmetry', 'Standard asymmetry'),
                ('UVB-shotnoise', 'UV shotnoise'),
                ('old_growth_func', 'old_growth_func')):
            if config.getboolean(option, False):
                raise not_ported(feature, 4)
        if config.getint('single_multipole', -1) >= 0:
            raise not_ported('single_multipole', 4)
        if (config.getboolean('new-bias-evolution', False)
                and tracer1['type'] != tracer2['type']):
            raise not_ported('new-bias-evolution', 4)
        for name in (tracer1['name'], tracer2['name']):
            if 'croom' in self._evol_model(name):
                raise not_ported('Croom bias evolution', 4)

        # delta rp only for the cross (reference: correlation_func.py:64-69)
        self._delta_rp_name = None
        if tracer1['type'] == 'discrete' and tracer2['type'] != 'discrete':
            self._delta_rp_name = 'drp_' + tracer1['name']
        elif tracer2['type'] == 'discrete' and tracer1['type'] != 'discrete':
            self._delta_rp_name = 'drp_' + tracer2['name']

        # Growth factor on the static z grid
        # (vega_tpu/correlation_func.py:290-307)
        z_fid = fiducial['z_fiducial']
        omega_m = fiducial.get('Omega_m', None)
        omega_de = fiducial.get('Omega_de', None)
        if omega_de is None:
            growth = ((1 + z_fid) / (1. + np.asarray(self._z))) ** 2
        else:
            growth = (growth_function(self._z, omega_m, omega_de)
                      / growth_function(z_fid, omega_m, omega_de)) ** 2
        # mean relative z-evolution (vega_tpu/correlation_func.py:229)
        rel_z_evol = (1. + np.asarray(self._z)) / (1 + fiducial['z_eff'])
        self.set_constants(xi_growth=growth, rel_z_evol=rel_z_evol)

    def set_constants(self, xi_growth, rel_z_evol):
        """Install the host growth and z-evolution arrays as tensors."""
        self.xi_growth = to_tensor(xi_growth, self.device)
        self._rel_z_evol = to_tensor(rel_z_evol, self.device)

    def _evol_model(self, tracer_name):
        handle_name = f'z evol {tracer_name}'
        if handle_name in self._config:
            return self._config.get(handle_name, 'standard')
        return self._config.get('z evol', 'standard')

    # ------------------------------------------------------------------
    def compute(self, pk, pktoxi_obj, params, use_kernel=True,
                sampling=None):
        """xi model for the input P(k); returns (xi, bad_flag)
        (vega_tpu/correlation_func.py:97-120). A FactoredXi from the
        transform stays factored unless the z-evolution read a sampled
        name (`sampling`), which densifies it first."""
        xi, bad = self.compute_core(pk, pktoxi_obj, params, use_kernel,
                                    sampling)
        rec = RecordingParams(params, sampling)
        evol = self.compute_bias_evol(rec)
        if isinstance(xi, FactoredXi) and rec.traced():
            xi = xi.dense()
        if isinstance(xi, FactoredXi):
            return xi.mul_vec(evol * self.xi_growth), bad
        xi = xi * evol
        xi = xi * self.xi_growth
        return xi, bad

    def compute_core(self, pk, pktoxi_obj, params, use_kernel=True,
                     sampling=None):
        """Hankel transform at the AP-rescaled coordinates
        (vega_tpu/correlation_func.py:175-198). The coordinates count as
        parameter-free when the rescaling read no sampled name other
        than a grid parameter."""
        rec = RecordingParams(params, sampling)
        delta_rp = 0.
        if self._delta_rp_name is not None:
            delta_rp = rec.get(self._delta_rp_name, 0.)
        ap, at = self._scale_params.get_ap_at(
            rec, corr_name=self._corr_name, metal_corr=self._metal_corr)
        rescaled_r, rescaled_mu = self._rescale_coords(
            self._r, self._mu, col(ap, 1), col(at, 1), col(delta_rp, 1))
        return pktoxi_obj.compute(rescaled_r, rescaled_mu, pk,
                                  use_kernel=use_kernel,
                                  coords_param_free=not rec.traced())

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
        """(1+z)^alpha power laws of both tracers
        (vega_tpu/correlation_func.py:250-276)."""
        rel = self._rel_z_evol
        evol = rel ** col(params[f'alpha_{self._tracer1["name"]}'], 1)
        return evol * rel ** col(params[f'alpha_{self._tracer2["name"]}'], 1)
