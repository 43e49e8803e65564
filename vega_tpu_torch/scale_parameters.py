"""Scale-parameter (alpha_par / alpha_perp) extraction.

Port of vega_tpu/scale_parameters.py (the `ap_at` routing, :18-108); the
arithmetic takes floats and (B,) tensors alike.

Counterpart of the reference's vega/scale_parameters.py (:12-230),
re-shaped as a routing table: a COMPONENT KIND (bao peak / full-shape /
smooth / metal / none) is resolved first from the config flags and the
'peak' component flag, then one of three pure coordinate maps converts
the named sampled parameters to (alpha_par, alpha_perp). All branching
is on static config values, and the
parameter NAMES a given configuration reads are enumerable up front
(`param_names`), which the grid collapse uses to know its dimensions.
"""

from __future__ import annotations

import math

import torch


def _map_ap_at(a_par, a_perp):
    return a_par, a_perp


def _map_aiso_epsilon(aiso, epsilon):
    # aiso = (ap * at^2)^(1/3)-style isotropic/anisotropic split
    return aiso * (1 + epsilon) ** 2, aiso / (1 + epsilon)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def _map_phi_alpha(phi, alpha):
    # phi = at/ap anisotropy, alpha = sqrt(ap * at)
    return alpha / _sqrt(phi), alpha * _sqrt(phi)


# parametrisation -> (coordinate map, BAO-peak names, full-shape names)
_TABLE = {
    'ap_at': (_map_ap_at, ('ap', 'at'), ('ap_full', 'at_full')),
    'aiso_epsilon': (_map_aiso_epsilon, ('aiso', 'epsilon'),
                     ('aiso_full', 'epsilon_full')),
    'phi_alpha': (_map_phi_alpha, ('phi', 'alpha'), None),  # names dynamic
}


class ScaleParameters:
    """(ap, at) routing for every component (reference:
    scale_parameters.py:4-231)."""

    def __init__(self, config):
        self.full_shape = config.getboolean('full-shape', False)
        self.full_shape_alpha = config.getboolean('full-shape-alpha', False)
        self.smooth_scaling = config.getboolean('smooth-scaling', False)
        self.metal_scaling = config.getboolean('metal-scaling', False)
        self.two_alpha_smooth = config.getboolean('two-alpha-smooth', False)

        incompatible = [opt for opt, flag in
                        [('full-shape-alpha', self.full_shape_alpha),
                         ('metal-scaling', self.metal_scaling)]
                        if flag and self.two_alpha_smooth]
        if incompatible:
            raise ValueError(f'The "{incompatible[0]}" and '
                             '"two-alpha-smooth" options are incompatible.')

        self.parametrisation = config.get('cosmo fit func', 'ap_at')
        if self.parametrisation not in _TABLE:
            raise ValueError(f'Unknown parametrisation {self.parametrisation}.')

    # -- kind resolution -----------------------------------------------
    def _component_kind(self, peak, metal_corr):
        """Which scaling applies to this component."""
        if metal_corr and not self.metal_scaling:
            return 'none'
        if self.full_shape:
            return 'fullshape'
        if peak:
            return 'bao'
        return 'smooth' if self.smooth_scaling else 'none'

    def _names_for(self, kind, peak, corr_name):
        """The two sampled-parameter names the coordinate map reads."""
        _, bao_names, full_names = _TABLE[self.parametrisation]
        if kind == 'bao':
            return bao_names
        # full-shape / smooth routing
        if self.parametrisation == 'phi_alpha':
            phi_name = 'phi_full' if self.full_shape else 'phi_smooth'
            if self.full_shape_alpha:
                alpha_name = 'alpha_full'
            elif peak:
                alpha_name = 'alpha'
            elif self.two_alpha_smooth:
                alpha_name = f'alpha_smooth_{corr_name}'
            else:
                alpha_name = 'alpha_smooth'
            return phi_name, alpha_name
        if not self.full_shape_alpha:
            raise ValueError(
                'Only the "phi_alpha" parametrisation works with split '
                'full-shape. Set full-shape-alpha to True otherwise.')
        return full_names

    # -- public API ----------------------------------------------------
    def get_ap_at(self, params, corr_name=None, metal_corr=False):
        """(alpha_par, alpha_perp) for one component; 'peak' in params is
        a static bool (reference: scale_parameters.py:38-66)."""
        peak = bool(params['peak'])
        kind = self._component_kind(peak, metal_corr)
        if kind == 'none':
            return 1., 1.
        coord_map, _, _ = _TABLE[self.parametrisation]
        name1, name2 = self._names_for(kind, peak, corr_name)
        return coord_map(params[name1], params[name2])

    def param_names(self, peak=True, corr_name=None, metal_corr=False):
        """The sampled names `get_ap_at` would read for this component
        (empty when the component is not rescaled)."""
        kind = self._component_kind(bool(peak), metal_corr)
        if kind == 'none':
            return ()
        return self._names_for(kind, bool(peak), corr_name)

    # -- vega_tpu's reference-named views of the routing table
    # (vega_tpu/scale_parameters.py:118-160)
    @staticmethod
    def default():
        return 1., 1.

    @staticmethod
    def ap_at(params, ap_name='ap', at_name='at'):
        return _map_ap_at(params[ap_name], params[at_name])

    @staticmethod
    def aiso_epsilon(params, aiso_name='aiso', epsilon_name='epsilon'):
        return _map_aiso_epsilon(params[aiso_name], params[epsilon_name])

    @staticmethod
    def phi_alpha(params, phi_name='phi', alpha_name='alpha'):
        return _map_phi_alpha(params[phi_name], params[alpha_name])

    def get_bao_params(self, params):
        coord_map, bao_names, _ = _TABLE[self.parametrisation]
        return coord_map(params[bao_names[0]], params[bao_names[1]])

    def get_fullshape_params(self, params, corr_name=None):
        coord_map, _, _ = _TABLE[self.parametrisation]
        name1, name2 = self._names_for(
            'fullshape', bool(params.get('peak', False)), corr_name)
        return coord_map(params[name1], params[name2])

    def get_fullshape_phi_alpha(self, params, corr_name=None):
        """Meaningful under the phi_alpha parametrisation alone, as in
        vega_tpu."""
        name1, name2 = self._names_for(
            'fullshape', bool(params['peak']), corr_name)
        return _map_phi_alpha(params[name1], params[name2])
