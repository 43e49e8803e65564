"""Per-correlation model assembly: the peak/smooth decomposition and the
distortion matrix.

Counterpart of vega_tpu/model.py (`compute`, :211-245) without metals,
broadband and instrumental systematics. The distortion matrix, where the
data carry one that is not the identity, is a dense f64 matmul
(vega_tpu/model.py:93-97,152-157).

With a `Sampling` the model takes the factored path where it can and
returns a FactoredXi whose terms are the peak's then the smooth's, in
the order of vega_tpu's; `coefficients` is its coefficient part, run per
evaluation on (B,) tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import correlation_func as corr_func
from . import pktoxi, power_spectrum
from .factored import FactoredXi, densify, stack_coefficients
from .utils import col, not_ported, to_tensor


class Model:
    """Correlation model for one component (reference: model.py:8-77)."""

    def __init__(self, corr_item, fiducial, scale_params, data=None, *,
                 device):
        self.device = torch.device(device)
        self._corr_item = corr_item
        if corr_item.model_coordinates is None:
            raise ValueError('CorrelationItem has no model coordinates')
        if corr_item.config['model'].getboolean(
                'desi-instrumental-systematics', False):
            raise not_ported('DESI instrumental systematics', 10)

        corr_item.config['model']['bin_size_rp'] = \
            str(corr_item.data_coordinates.rp_binsize)
        corr_item.config['model']['bin_size_rt'] = \
            str(corr_item.data_coordinates.rt_binsize)

        self.Pk_core = power_spectrum.PowerSpectrum(
            corr_item.config['model'], fiducial, corr_item.tracer1,
            corr_item.tracer2, corr_item.name, device=self.device)
        self.PktoXi = pktoxi.PktoXi.init_from_Pk(
            self.Pk_core, corr_item.config['model'])
        self.Xi_core = corr_func.CorrelationFunction(
            corr_item.config['model'], fiducial, corr_item.model_coordinates,
            scale_params, corr_item.tracer1, corr_item.tracer2,
            device=self.device)

        # Dense distortion matrix; skipped when it is exactly the
        # identity (the data layer substitutes eye for an absent one)
        self._dist_mat = None
        if (corr_item.has_distortion and data is not None
                and data.has_distortion):
            dist = np.asarray(data.distortion_mat, dtype=np.float64)
            if not np.array_equal(dist, np.eye(*dist.shape)):
                self._dist_mat = to_tensor(dist, self.device)

    def _compute_model(self, pars, pk_model, use_kernel, sampling=None):
        """One component's correlation function
        (vega_tpu/model.py:100-165)."""
        xi_model, bad = self.Xi_core.compute(pk_model, self.PktoXi, pars,
                                             use_kernel, sampling)
        if self._dist_mat is not None:
            if isinstance(xi_model, FactoredXi):
                xi_model = xi_model.matmul(self._dist_mat)
            else:
                xi_model = xi_model @ self._dist_mat.T
        return xi_model, bad

    def compute(self, pars, pk_full, pk_smooth, use_kernel=True,
                sampling=None, pk_cache=None):
        """Peak/smooth decomposition (vega_tpu/model.py:211-245).

        pars : dict of floats and (B,) tensors
        pk_full, pk_smooth : (n_k,) tensors
        sampling : a factored.Sampling for the factored path, or None
        pk_cache : a dict that keeps the factored power spectra (and their
            knot tables) between calls with the same sampled set, when no
            grid parameter shaped them (the grid sweep's node chunks)
        Returns (xi_full, bad (B',)): xi_full is (B', M), B' = 1 when no
        parameter the model reads is batched, or a FactoredXi.
        """
        pars = dict(pars)
        pars['peak'] = True
        if pk_cache is not None and 'pk' in pk_cache:
            pk_peak, pk_smooth_grid = pk_cache['pk']
        else:
            pk_peak, pk_smooth_grid, _ = self.Pk_core.compute_peak_smooth(
                pars, pk_full - pk_smooth, pk_smooth, sampling)
            if (pk_cache is not None
                    and isinstance(pk_peak, power_spectrum.FactoredPk)
                    and pk_peak.grid_free):
                pk_cache['pk'] = (pk_peak, pk_smooth_grid)
        xi_peak, bad_peak = self._compute_model(pars, pk_peak, use_kernel,
                                                sampling)
        del pk_peak

        pars['peak'] = False
        xi_smooth, bad_smooth = self._compute_model(pars, pk_smooth_grid,
                                                    use_kernel, sampling)
        if isinstance(xi_peak, FactoredXi):
            xi_peak = xi_peak.scale(pars['bao_amp'])
        else:
            xi_peak = col(pars['bao_amp'], 1) * xi_peak
        # both factored: the terms concatenate; a mixed pair densifies
        # the factored side (vega_tpu/model.py:167-178)
        if isinstance(xi_peak, FactoredXi) and isinstance(xi_smooth,
                                                          FactoredXi):
            return xi_peak + xi_smooth, bad_peak | bad_smooth
        return densify(xi_peak) + densify(xi_smooth), bad_peak | bad_smooth

    def coefficients(self, pars, n_rows):
        """The coefficient part of the factored model: (n_rows, T), the
        peak's terms times bao_amp, then the smooth's, as `compute`
        orders them. Reads only scalars and (B,) tensors."""
        kaiser = self.Pk_core.kaiser_coefficients(pars)
        coeffs = [pars['bao_amp'] * c for c in kaiser] + kaiser
        return stack_coefficients(coeffs, self.Pk_core._muk_t).expand(
            n_rows, len(coeffs))
