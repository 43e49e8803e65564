"""Per-correlation configuration item.

Counterpart of vega_tpu/correlation_item.py for the dense likelihood:
tracer info, config sections, coordinates, the metal correlation list,
the stacked-delta weights files of the new-metals mode and the cosmology
of the data file's header, which the new-metals matrices read, and the
broadband's binning. Small-scale marginalization is not ported yet and
raises at construction.
"""

from __future__ import annotations

from .cosmo import Cosmo
from .utils import not_ported


class CorrelationItem:
    """Tracer info, config sections and coordinates of one correlation
    component (reference: correlation_item.py:8-75)."""

    cosmo = None
    low_mem_mode = False
    model_coordinates = None
    dist_model_coordinates = None
    data_coordinates = None

    def __init__(self, config):
        self.config = config
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
        self.has_metals = False
        self.has_bb = False
        marg_options = ('marginalize-below-rtmax', 'marginalize-above-rtmin',
                        'marginalize-below-rpmax', 'marginalize-above-rpmin')
        if (any(config['model'].getfloat(opt, 0) > 0 for opt in marg_options)
                or config['model'].getboolean('marginalize-all-rmin-cuts',
                                              False)):
            raise not_ported('Small-scale marginalization', 5)

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
