"""Per-correlation configuration item.

Counterpart of vega_tpu/correlation_item.py for the dense likelihood:
tracer info, config sections and coordinates. Metals, broadband and
small-scale marginalization are not ported yet and raise at construction.
"""

from __future__ import annotations

from .utils import not_ported


class CorrelationItem:
    """Tracer info, config sections and coordinates of one correlation
    component (reference: correlation_item.py:8-75)."""

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

        if 'metals' in config or config['model'].getboolean('new_metals',
                                                            False):
            raise not_ported('Metals', 10)
        if 'broadband' in config:
            raise not_ported('Broadband polynomials', 10)
        marg_options = ('marginalize-below-rtmax', 'marginalize-above-rtmin',
                        'marginalize-below-rpmax', 'marginalize-above-rpmin')
        if (any(config['model'].getfloat(opt, 0) > 0 for opt in marg_options)
                or config['model'].getboolean('marginalize-all-rmin-cuts',
                                              False)):
            raise not_ported('Small-scale marginalization', 10)

    def init_coordinates(self, model_coordinates, dist_model_coordinates=None,
                         data_coordinates=None):
        self.model_coordinates = model_coordinates
        self.data_coordinates = (model_coordinates if data_coordinates is None
                                 else data_coordinates)
        self.dist_model_coordinates = (
            model_coordinates if dist_model_coordinates is None
            else dist_model_coordinates)
