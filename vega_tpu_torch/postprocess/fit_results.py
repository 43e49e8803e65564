"""Fit-results reader.

Counterpart of vega_tpu/postprocess/fit_results.py:24-167: reads the
output FITS files of either package (tests/test_torch_output.py).
getdist is optional: when absent, the Gaussian-approximation chain is a
lightweight internal MCSamples stand-in with the same core surface
(samples / getParamNames-ish access).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.stats as stats

from ..io.fits import read_fits
from ..parameters.param_utils import build_names
from ..utils import find_file


@dataclass
class CorrelationOutput:
    model: np.ndarray
    model_mask: np.ndarray
    data: np.ndarray
    data_mask: np.ndarray
    variance: np.ndarray
    rp: np.ndarray
    rt: np.ndarray
    z: np.ndarray

    size: Optional[int] = None
    chisq: Optional[float] = None
    reduced_chisq: Optional[float] = None
    p_value: Optional[float] = None
    bestfit_marg_coeff: Optional[np.ndarray] = None


class GaussianChain:
    """Minimal MCSamples-compatible container for Gaussian draws."""

    def __init__(self, samples, names, labels):
        self.samples = samples
        self.names = list(names)
        self.labels = list(labels)

    def mean(self, name):
        return float(self.samples[:, self.names.index(name)].mean())

    def std(self, name):
        return float(self.samples[:, self.names.index(name)].std())


class FitResults:
    """(reference: postprocess/fit_results.py:32-65)"""

    def __init__(self, path, results_only=False, no_chain=False):
        hdul = read_fits(find_file(path))
        by_name = {h.name: h for h in hdul if getattr(h, 'name', '')}

        bestfit = by_name['BESTFIT']
        self.chisq = bestfit.header['FVAL']
        self.valid = bestfit.header['VALID']
        self.accurate = bestfit.header['ACCURATE']
        self.names = np.asarray(bestfit['names'])
        self.mean = np.asarray(bestfit['values'])
        self.cov = np.asarray(bestfit['covariance'])
        self.params = dict(zip(self.names, self.mean))
        self.sigmas = dict(zip(self.names, np.asarray(bestfit['errors'])))
        self.num_pars = len(self.names)

        self.marg_coeff = {}
        if not results_only:
            self.read_correlations(hdul)

        if not results_only and not no_chain:
            self.chain = self.make_chain(self.names, self.mean, self.cov)

    @staticmethod
    def make_chain(names, mean, cov, size=100000):
        """Gaussian-approximation chain (reference:
        postprocess/fit_results.py:67-87); returns a getdist MCSamples
        when available, an internal GaussianChain otherwise."""
        labels = build_names(names)
        samples = np.random.multivariate_normal(mean, cov, size=size)
        try:
            from getdist import MCSamples
            return MCSamples(samples=samples, names=list(names),
                             labels=list(labels.values()))
        except ImportError:
            return GaussianChain(samples, names, list(labels.values()))

    def read_correlations(self, hdul):
        """(reference: postprocess/fit_results.py:89-142)"""
        model_hdus = [h for h in hdul
                      if getattr(h, 'name', '').startswith('MODEL')]
        if len(model_hdus) == 0:
            raise ValueError('No model HDUs found in the fit results file.')
        if model_hdus[0].name == 'MODEL':
            # legacy single-HDU format (reference: fit_results.py:99-101)
            self.old_read_correlations(model_hdus[0])
            return

        self.correlations = {}
        self.num_data_points = 0
        for hdu in model_hdus:
            corr_name = hdu.name.split('_', 1)[1]

            model = hdu[corr_name + '_MODEL']
            model_mask = hdu[corr_name + '_MODEL_MASK']
            data = hdu[corr_name + '_DATA']
            data_mask = hdu[corr_name + '_MASK']
            self.num_data_points += int(np.sum(data_mask))

            variance = hdu[corr_name + '_VAR']
            rp = hdu[corr_name + '_RP']
            rt = hdu[corr_name + '_RT']
            z = hdu[corr_name + '_Z']

            def _h(key):
                return hdu.header.get(key[:8].upper(),
                                      hdu.header.get(key, None))

            bestfit_marg_coeff = []
            i = 0
            while _h(f'marg_coeff_{i}') is not None:
                bestfit_marg_coeff.append(_h(f'marg_coeff_{i}'))
                i += 1
            bestfit_marg_coeff = np.array(bestfit_marg_coeff)

            lowercase = corr_name.lower()
            self.marg_coeff[lowercase] = bestfit_marg_coeff
            self.correlations[lowercase] = CorrelationOutput(
                model, model_mask, data, data_mask, variance, rp, rt, z,
                size=_h('masked_size'), chisq=_h('chisq'),
                reduced_chisq=_h('reduced_chisq'), p_value=_h('p_value'),
                bestfit_marg_coeff=bestfit_marg_coeff)

        self.p_value = 1 - stats.chi2.cdf(
            self.chisq, self.num_data_points - self.num_pars)
        self.reduced_chisq = self.chisq / (
            self.num_data_points - self.num_pars)

    def old_read_correlations(self, hdu):
        """Legacy single-HDU 'MODEL' format: 9 flat columns per
        correlation (reference: fit_results.py:144-175)."""
        names = list(hdu.columns.keys())
        if len(names) % 9 != 0:
            raise ValueError('Vega output format has changed. '
                             'Please update fit reader.')

        self.correlations = {}
        self.num_data_points = 0
        for i in range(len(names) // 9):
            model_name = names[i * 9]
            assert model_name[-6:] == '_MODEL'
            corr_name = model_name[:-6]

            data_mask = hdu[corr_name + '_MASK']
            self.num_data_points += int(np.sum(data_mask))
            self.correlations[corr_name] = CorrelationOutput(
                hdu[model_name], hdu[corr_name + '_MODEL_MASK'],
                hdu[corr_name + '_DATA'], data_mask,
                hdu[corr_name + '_VAR'], hdu[corr_name + '_RP'],
                hdu[corr_name + '_RT'], hdu[corr_name + '_Z'])
