"""Base sampler interface.

Counterpart of vega_tpu/samplers/sampler_interface.py (host numpy,
copied): one process drives batched likelihood evaluations on one device;
no rank gating.
"""

from __future__ import annotations

import os.path
from pathlib import Path

import numpy as np

from ..parameters.param_utils import build_names


def host_array(values):
    """A likelihood's batch of values as a host numpy array: the port's
    likelihoods return a tensor on their device, a plain callable numpy."""
    if hasattr(values, 'detach'):
        values = values.detach().cpu().numpy()
    return np.asarray(values)


class Sampler:
    """Sampler base: prior-limit validation, getdist .paramnames writing,
    derived-parameter bookkeeping (reference: sampler_interface.py:11-124).
    """

    def __init__(self, sampler_config, limits, log_lik_func,
                 derived_dict=None):
        self.limits = limits
        self.names = list(limits.keys())
        self.num_params = len(limits)
        self.derived_dict = None
        self.num_derived = 0
        if derived_dict is not None:
            self.derived_dict = derived_dict
            self.num_derived = int(np.sum(
                [num for num in derived_dict.values()]))

        self.log_lik = log_lik_func
        self.getdist_latex = sampler_config.getboolean('getdist_latex', True)

        for lims in self.limits.values():
            if None in lims:
                raise ValueError('Sampler needs well-defined prior limits. '
                                 'You passed a None. Give numbers, or say '
                                 'par_name = True to use defaults.')

        self.path = os.path.expandvars(sampler_config.get('path'))
        self.name = sampler_config.get('name')

        output_path = Path(self.path)
        assert output_path.exists(), (
            "The sampler 'path' does not correspond to an existing folder. "
            'Create the output folder before running.')
        self.write_parnames(output_path / (self.name + '.paramnames'))

        self.get_sampler_settings(sampler_config, self.num_params,
                                  self.num_derived)

    def write_parnames(self, parnames_path):
        """getdist-compatible .paramnames
        (reference: sampler_interface.py:66-100, rank-0 gating dropped)."""
        print('Writing parameter names')
        latex_names = build_names(list(self.names))

        if self.derived_dict is not None:
            for corr in sorted(self.derived_dict.keys()):
                for i in range(self.derived_dict[corr]):
                    latex_names[f'{corr}_marg_{i}'] = (
                        r'M_{\rm ' + f'{corr}' + '}^{' + f'{i}' + '}')

        with open(parnames_path, 'w') as f:
            for name, latex in latex_names.items():
                if self.getdist_latex:
                    f.write(f'{name}    {latex}\n')
                else:
                    f.write(f'{name}    ${latex}$\n')

    def get_sampler_settings(self, sampler_config, num_params, num_derived):
        raise NotImplementedError(
            'This method should be implemented in the child class')

    def run(self):
        raise NotImplementedError(
            'This method should be implemented in the child class')

    # Convenience shared by the native samplers -------------------------
    def prior_transform(self, unit_cube):
        """Map the unit hypercube to physical parameters (uniform priors,
        same convention as the reference's PolyChord prior)."""
        cube = np.atleast_2d(unit_cube)
        lo = np.array([self.limits[n][0] for n in self.names])
        hi = np.array([self.limits[n][1] for n in self.names])
        return lo + cube * (hi - lo)

    def write_chain(self, samples, weights, loglikes, suffix=''):
        """Write a getdist-format chain: weight, -2lnL, params."""
        chain_path = Path(self.path) / (self.name + suffix + '.txt')
        chain = np.column_stack((weights, -2 * loglikes, samples))
        print(f'Writing chain to {chain_path}')
        np.savetxt(chain_path, chain,
                   header='weight -2lnL ' + ' '.join(self.names))
        return chain_path
