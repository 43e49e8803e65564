"""Broadband polynomials.

Counterpart of vega_tpu/broadband_poly.py: the [broadband] section's
parsing and its errors (:21-64), the power-law design matrices built once
on the host (`_design_matrix`, :77-98), `compute` for pre / post x add /
mul (:100-132), `compute_add_terms`, the additive columns as factored
terms (:134-159), and the Gaussian sky residual (:161-173).

Each design matrix is (n_bins, n_coeff) numpy on the host (f64), kept
as a device tensor in the model's dtype; a polynomial is one
(B, n_coeff) x (n_coeff, n_bins) product with the coefficients, floats
or (B,) tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .factored import RecordingParams, stack_coefficients
from .utils import col, to_tensor


class BroadbandPolynomials:
    """(reference: broadband_poly.py:4-72 for the config surface)"""

    def __init__(self, bb_input, cf_name, model_coordinates,
                 dist_model_coordinates, *, device, dtype=torch.float64):
        self.device = torch.device(device)
        self.model_coordinates = model_coordinates
        self.dist_model_coordinates = dist_model_coordinates

        self.bb_terms = {'pre-add': [], 'pre-mul': [],
                         'post-add': [], 'post-mul': []}

        for i, bb in enumerate(bb_input.values()):
            bb = bb.split()
            if len(bb) not in [5, 6]:
                raise ValueError('Broadband setup must have 5 or 6 elements. '
                                 f'Got {len(bb)} elements')
            if bb[0] not in ['add', 'mul']:
                raise ValueError(f'Broadband type must be "add" or "mul". '
                                 f'Got {bb[0]}')
            if bb[1] not in ['pre', 'post']:
                raise ValueError(f'Broadband position must be "pre" or '
                                 f'"post". Got {bb[1]}')
            if bb[2] not in ['rp,rt', 'r,mu']:
                raise ValueError('Broadband coordinates must be "rp,rt" or '
                                 f'"r,mu". Got {bb[2]}')
            for spec in (bb[3], bb[4]):
                if len(spec.split(':')) != 3:
                    raise ValueError('Broadband ranges must be '
                                     f'"min:max:step". Got {spec}')
            if len(bb) > 5 and bb[5] != 'broadband_sky':
                raise ValueError('The sixth broadband element must be '
                                 f'"broadband_sky". Got {bb[5]}')

            r1_min, r1_max, dr1 = (int(v) for v in bb[3].split(':'))
            r2_min, r2_max, dr2 = (int(v) for v in bb[4].split(':'))
            if len(bb) > 5:
                name = f'BB-{cf_name}-{i}-{bb[5]}'
            else:
                name = f'BB-{cf_name}-{i} {bb[0]} {bb[1]} {bb[2]}'

            self.bb_terms[f'{bb[1]}-{bb[0]}'].append({
                'name': name,
                'func': 'broadband' if len(bb) == 5 else bb[5],
                'coordinates': bb[2],
                'r1_config': (r1_min, r1_max, dr1),
                'r2_config': (r2_min, r2_max, dr2),
            })

        # the power-law design matrices (host numpy) and their device
        # copies, per (position type, term name)
        self.designs = {}
        self._design_t = {}
        for pos_type, terms in self.bb_terms.items():
            for term in terms:
                if term['func'] != 'broadband':
                    continue
                key = (pos_type, term['name'])
                design, names = self._design_matrix(term,
                                                    self._coords(pos_type))
                self.designs[key] = (design, names)
                self._design_t[key] = to_tensor(design, self.device, dtype)
        # rt of each position's coordinates for the sky term, and its
        # support 0 <= rp < the rp bin size, taken on the host grids
        self._sky_grids = {}
        for position in ('pre', 'post'):
            coords = self._coords(position)
            support = ((coords.rp_grid >= 0.)
                       & (coords.rp_grid < coords.rp_binsize))
            self._sky_grids[position] = (
                to_tensor(coords.rt_grid, self.device, dtype),
                torch.as_tensor(np.asarray(support), device=self.device))

    def _coords(self, pos_type):
        return (self.model_coordinates if 'pre' in pos_type
                else self.dist_model_coordinates)

    @staticmethod
    def _design_matrix(bb_term, coordinates):
        """(n_bins, n_coeff) matrix of r1^i * r2^j columns, and the ordered
        coefficient parameter names (vega_tpu/broadband_poly.py:77-98)."""
        if bb_term['coordinates'] == 'r,mu':
            r1 = coordinates.r_grid / 100.
            r2 = coordinates.mu_grid
        else:
            r1 = coordinates.r_grid / 100. * coordinates.mu_grid
            r2 = (coordinates.r_grid / 100.
                  * np.sqrt(1 - coordinates.mu_grid ** 2))

        r1_min, r1_max, dr1 = bb_term['r1_config']
        r2_min, r2_max, dr2 = bb_term['r2_config']
        r1_powers = np.arange(r1_min, r1_max + 1, dr1)
        r2_powers = np.arange(r2_min, r2_max + 1, dr2)

        columns, names = [], []
        for i in r1_powers:
            for j in r2_powers:
                columns.append(r1 ** float(i) * r2 ** float(j))
                names.append(f'{bb_term["name"]} ({i},{j})')
        return np.stack(columns, axis=1), names

    def compute(self, params, pos_type):
        """Total broadband of one position type
        (vega_tpu/broadband_poly.py:100-132): 1. or 0. without terms,
        else an (n_bins,) or (B, n_bins) tensor."""
        if pos_type not in self.bb_terms:
            raise ValueError(f'pos_type must be one of '
                             f'{list(self.bb_terms)}, got {pos_type}')
        bb_total = None
        for term in self.bb_terms[pos_type]:
            if term['func'] == 'broadband':
                key = (pos_type, term['name'])
                design = self._design_t[key]
                coeffs = stack_coefficients(
                    [params[name] for name in self.designs[key][1]], design)
                bb_poly = coeffs @ design.T
            else:
                bb_poly = self._compute_broadband_sky(
                    term['name'], params, pos_type.split('-')[0])

            if bb_total is None:
                bb_total = 1 + bb_poly if 'mul' in pos_type else bb_poly
            elif 'mul' in pos_type:
                bb_total = bb_total * (1 + bb_poly)
            else:
                bb_total = bb_total + bb_poly

        if bb_total is None:
            bb_total = 1. if 'mul' in pos_type else 0.
        return bb_total

    def compute_add_terms(self, params, position, sampling):
        """The additive broadband of one position as factored [(coeff,
        column)] terms (vega_tpu/broadband_poly.py:134-159): each design
        column with its coefficient parameter, the sky term with
        coefficient 1. None when the sky term read a sampled name that is
        not a grid parameter: the factored form cannot carry it."""
        pos_type = f'{position}-add'
        terms = []
        for term in self.bb_terms[pos_type]:
            if term['func'] == 'broadband':
                key = (pos_type, term['name'])
                design = self._design_t[key]
                for j, name in enumerate(self.designs[key][1]):
                    terms.append((params[name], design[:, j]))
            else:
                rec = RecordingParams(params, sampling)
                vec = self._compute_broadband_sky(term['name'], rec,
                                                  position)
                if rec.traced():
                    return None
                terms.append((1.0, vec))
        return terms

    def add_coefficients(self, params, position):
        """The coefficients of `compute_add_terms`' terms: floats or (B,)
        tensors, without a column."""
        coeffs = []
        for term in self.bb_terms[f'{position}-add']:
            if term['func'] == 'broadband':
                coeffs += [params[name] for name in
                           self.designs[(f'{position}-add',
                                         term['name'])][1]]
            else:
                coeffs.append(1.0)
        return coeffs

    def _compute_broadband_sky(self, bb_term_name, params, position):
        """Gaussian sky-residual broadband in rt, on 0 <= rp < the rp bin
        size (vega_tpu/broadband_poly.py:161-173): (n_bins,) or
        (B, n_bins)."""
        scale = col(params[bb_term_name + '-scale-sky'], 1)
        sigma = col(params[bb_term_name + '-sigma-sky'], 1)
        rt, support = self._sky_grids[position]
        corr = scale / (sigma * math.sqrt(2. * math.pi))
        corr = corr * torch.exp(-0.5 * (rt / sigma) ** 2)
        return torch.where(support, corr, 0.)
