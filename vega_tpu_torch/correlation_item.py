"""Per-correlation configuration item.

Counterpart of vega_tpu/correlation_item.py: tracer info, config
sections, coordinates, the metal correlation list, the stacked-delta
weights files of the new-metals mode and the cosmology of the data
file's header, which the new-metals matrices read, the broadband's
binning, the small-scale marginalization options with their
undistorted templates (`get_undist_xi_marg_templates`; data.py distorts
them and builds the covariance update and the coefficient matrix),
`model_pk` (the model's multipoles instead of its correlation), whether
the correlation has a data file (`has_data`) and which blinded tracers
it carries (`check_if_blind_corr`).
"""

from __future__ import annotations

from functools import reduce

import numpy as np

from .cosmo import Cosmo


class CorrelationItem:
    """Tracer info, config sections and coordinates of one correlation
    component (reference: correlation_item.py:8-75)."""

    cosmo = None
    low_mem_mode = False
    model_coordinates = None
    dist_model_coordinates = None
    data_coordinates = None

    def __init__(self, config, model_pk=False):
        self.config = config
        self.model_pk = model_pk
        self.name = config['data'].get('name')
        self.tracer1 = {
            'name': config['data'].get('tracer1'),
            'type': config['data'].get('tracer1-type'),
        }
        self.tracer2 = {
            'name': config['data'].get('tracer2', self.tracer1['name']),
            'type': config['data'].get('tracer2-type', self.tracer1['type']),
        }

        self.has_distortion = config['data'].getboolean('distortion', True)
        self.cov_rescale = config['data'].getfloat('cov_rescale', None)

        # (vega_tpu/correlation_item.py:43-45)
        self.has_data = config['data'].getboolean('has_datafile', True)
        if 'filename' not in config['data']:
            self.has_data = False

        # stacked-delta weights of the new-metals matrices
        # (vega_tpu/correlation_item.py:47-53)
        self.new_metals = config['model'].getboolean('new_metals', False)
        if self.new_metals:
            self.tracer1['weights-path'] = config['data'].get(
                'weights-tracer1')
            self.tracer2['weights-path'] = config['data'].get(
                'weights-tracer2', None)
            if self.tracer2['weights-path'] is None:
                self.tracer2['weights-path'] = self.tracer1['weights-path']
        self.test_flag = config['data'].getboolean('test', False)

        # small-scale marginalization (vega_tpu/correlation_item.py:57-77)
        marg_rs = [
            config['model'].getfloat('marginalize-below-rtmax', 0),
            config['model'].getfloat('marginalize-above-rtmin', 0),
            config['model'].getfloat('marginalize-below-rpmax', 0),
            config['model'].getfloat('marginalize-above-rpmin', 0),
        ]
        self.marginalize_small_scales_prior_sigma = config['model'].getfloat(
            'marginalize-prior-sigma', 10.0)
        self.marginalize_small_scales = {}
        for value, name in zip(marg_rs, ['rtmax', 'rtmin', 'rpmax', 'rpmin']):
            if value > 0:
                self.marginalize_small_scales[name] = value
        if config['model'].getboolean('marginalize-all-rmin-cuts', False):
            self.marginalize_small_scales['all-rmin'] = True
        self.marginalize_match_data_bins = config['model'].getboolean(
            'marginalize-match-data-bins', False)
        self.fit_marg_scales = config['model'].getboolean(
            'fit-marginalized-scales', False)

        self.has_metals = False
        self.has_bb = False

    def init_metals(self, tracer_catalog, metal_correlations):
        """Normalize and dedupe the metal correlation list
        (reference: correlation_item.py:77-106)."""
        self.tracer_catalog = tracer_catalog
        self.metal_correlations = []
        for corr in metal_correlations:
            corr_hash = tuple(sorted([corr[0], corr[1]]))
            if (corr_hash[0] == self.tracer2['name']
                    or corr_hash[1] == self.tracer1['name']):
                corr_hash = (corr_hash[1], corr_hash[0])
            if corr_hash not in self.metal_correlations:
                self.metal_correlations.append(corr_hash)
        self.has_metals = True

    def init_broadband(self, coeff_binning_model):
        """(vega_tpu/correlation_item.py:98-100)"""
        self.coeff_binning_model = coeff_binning_model
        self.has_bb = True

    def init_cosmo(self, cosmo_params):
        """The data file's cosmology (vega_tpu/correlation_item.py:111-117)."""
        self.cosmo_params = cosmo_params
        self.cosmo = Cosmo(
            Om=cosmo_params['Omega_m'], Ok=cosmo_params['Omega_k'],
            Or=cosmo_params['Omega_r'], wl=cosmo_params['wl'])

    def init_coordinates(self, model_coordinates, dist_model_coordinates=None,
                         data_coordinates=None):
        self.model_coordinates = model_coordinates
        self.data_coordinates = (model_coordinates if data_coordinates is None
                                 else data_coordinates)
        self.dist_model_coordinates = (
            model_coordinates if dist_model_coordinates is None
            else dist_model_coordinates)

    def check_if_blind_corr(self, blind_tracers):
        """Whether a blinded name of `blind_tracers` ('all' or tracer
        names) reaches this correlation (vega_tpu/correlation_item.py:
        119-128)."""
        if 'all' in blind_tracers:
            return True
        for tracer in blind_tracers:
            if (tracer in self.tracer1['name']
                    or tracer in self.tracer2['name']):
                return True
        return False

    def get_undist_xi_marg_templates(self):
        """Undistorted marginalization templates, a dense (n_model,
        n_templates) indicator matrix (vega_tpu/correlation_item.py:
        129-185): one column per model bin inside every box option, or
        per bin the distorted-space small-scale mask leaves out
        (all-rmin, upsampled onto the model grid by np.kron); with
        marginalize-match-data-bins one column per nearest data bin."""
        if 'all-rmin' not in self.marginalize_small_scales:
            indices = []
            coords = self.model_coordinates
            if 'rtmax' in self.marginalize_small_scales:
                indices.append(np.nonzero(
                    coords.rt_regular_grid
                    < self.marginalize_small_scales['rtmax'])[0])
            if 'rtmin' in self.marginalize_small_scales:
                indices.append(np.nonzero(
                    coords.rt_regular_grid
                    > self.marginalize_small_scales['rtmin'])[0])
            if 'rpmax' in self.marginalize_small_scales:
                indices.append(np.nonzero(
                    np.abs(coords.rp_regular_grid)
                    < self.marginalize_small_scales['rpmax'])[0])
            if 'rpmin' in self.marginalize_small_scales:
                indices.append(np.nonzero(
                    np.abs(coords.rp_regular_grid)
                    > self.marginalize_small_scales['rpmin'])[0])
            common_idx = reduce(np.intersect1d, indices)
            if common_idx.size == 0:
                raise ValueError('No common indices found for small-scale '
                                 'marginalization templates.')
        else:
            rp_nbins_dist = self.dist_model_coordinates.rp_nbins
            rt_nbins_dist = self.dist_model_coordinates.rt_nbins
            rp_nbins = self.model_coordinates.rp_nbins
            rt_nbins = self.model_coordinates.rt_nbins
            cb = rp_nbins // rp_nbins_dist
            mask_dist = self.dist_model_coordinates.get_mask_scale_cuts(
                self.config['cuts'], small_scale_mask=True
            ).reshape(rp_nbins_dist, rt_nbins_dist)
            # the distorted-space mask upsampled onto the model grid
            mask_model = np.kron(mask_dist, np.ones((cb, cb), dtype=bool))
            common_idx = np.nonzero(
                ~mask_model.reshape(rp_nbins * rt_nbins))[0]
            print(f'Marginalizing distortion scales with {common_idx.size} '
                  'points based on scale cuts.')

        n_model = self.model_coordinates.rt_regular_grid.size
        if self.marginalize_match_data_bins:
            rp = self.model_coordinates.rp_grid[common_idx]
            rt = self.model_coordinates.rt_grid[common_idx]
            dist_rp = self.dist_model_coordinates.rp_grid
            dist_rt = self.dist_model_coordinates.rt_grid
            idx_in_data = ((dist_rp[None, :] - rp[:, None]) ** 2
                           + (dist_rt[None, :] - rt[:, None]) ** 2
                           ).argmin(axis=1)
            unique_idx = np.unique(idx_in_data)
            rows = np.searchsorted(unique_idx, idx_in_data)
            templates = np.zeros((n_model, unique_idx.size))
            templates[common_idx, rows] = 1.0
        else:
            templates = np.zeros((n_model, common_idx.size))
            templates[common_idx, np.arange(common_idx.size)] = 1.0
        return templates
