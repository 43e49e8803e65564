"""Analysis: chi^2 scans and Monte-Carlo mock fits.

Counterpart of vega_tpu/analysis.py:26-239. Scans are batched by default:
every grid point is one row of the batched exact-derivative Newton of
parallel/batch.py on the interface's device. The serial loops (the scan
with `[control] batched_scan = False`, `run_monte_carlo`) follow the
reference point for point and seed for seed: host mocks come from the
numpy global RNG, as vega_tpu's do, the mock of the joint data vector
under a global covariance too (`create_global_monte_carlo`).
"""

from __future__ import annotations

import itertools
import sys

import numpy as np

from . import mocks
from .minimizer import Minimizer


class Analysis:
    """(vega_tpu/analysis.py:26-49)"""

    def __init__(self, chi2_func, sampler_params, main_config, corr_items,
                 data, mc_config=None, global_cov=None, grad_func=None,
                 hess_func=None, vega=None):
        self.config = main_config
        self._vega = vega
        self._chi2_func = chi2_func
        self._grad_func = grad_func
        self._hess_func = hess_func
        self._valgrad_func = (vega.chi2_value_and_gradient
                              if vega is not None else None)
        self._scan_minimizer = Minimizer(
            chi2_func, sampler_params, grad_func=grad_func,
            hess_func=hess_func, valgrad_func=self._valgrad_func)
        self._corr_items = corr_items
        self._data = data
        self.mc_config = mc_config
        self.has_monte_carlo = False
        self._global_cov = global_cov
        self._cholesky_global_cov = None

    # ------------------------------------------------------------------
    # chi^2 scans
    # ------------------------------------------------------------------
    def _read_scan_grids(self):
        if 'chi2 scan' not in self.config:
            raise ValueError('Called chi2_scan, but no "[chi2 scan]" section '
                             'in main.ini.')
        grids = {}
        for param, value in self.config.items('chi2 scan'):
            start, end, num_points = value.split()
            grids[param] = np.linspace(float(start), float(end),
                                       int(num_points))
        if not 1 <= len(grids) <= 2:
            raise ValueError('chi2_scan only supports one/two parameter scans')
        return grids

    def _use_batched_scan(self):
        if self._vega is None:
            return False
        if 'control' in self.config:
            return self.config['control'].getboolean('batched_scan', True)
        return True

    def chi2_scan(self):
        """1D/2D profile scan over the [chi2 scan] grids, re-minimizing
        the free parameters at each grid point (vega_tpu/analysis.py:
        74-107): one batched Newton over every point by default, else the
        serial re-minimization loop. Returns a list of
        {name: value, 'fval': chi^2} in C order (first name outer)."""
        self.grids = self._read_scan_grids()

        if self._use_batched_scan():
            from .parallel.batch import batched_chi2_scan
            self.scan_results = batched_chi2_scan(
                self._vega, self.grids,
                sample_params=self._vega.sample_params)
            return self.scan_results

        scan_names = list(self.grids)
        overrides = {'fix': {p: True for p in scan_names},
                     'errors': {p: 0. for p in scan_names},
                     'values': {}}
        points = list(itertools.product(*(self.grids[p]
                                          for p in scan_names)))
        self.scan_results = []
        for i, point in enumerate(points):
            overrides['values'] = dict(zip(scan_names, point))
            self._scan_minimizer.minimize(overrides)
            row = self._scan_minimizer.values
            row['fval'] = self._scan_minimizer.fmin.fval
            self.scan_results.append(row)
            print(f'INFO: finished chi2scan iteration {i + 1} of '
                  f'{len(points)}')
        return self.scan_results

    # ------------------------------------------------------------------
    # Mock generation (host-side; the device-batched generator is
    # parallel.MonteCarloEngine)
    # ------------------------------------------------------------------
    def create_monte_carlo_sim(self, fiducial_model, seed=None, scale=None,
                               forecast=False):
        """One mock per correlation (vega_tpu/analysis.py:113-122)."""
        return {
            name: self._data[name].create_monte_carlo(
                fiducial_model[name],
                mocks.resolve_scale(scale, self._corr_items[name], name),
                seed, forecast)
            for name in self._corr_items
        }

    def _global_mock_pieces(self, fiducial_model):
        """(joint data mask, fiducial concatenated on the joint grid)
        (vega_tpu/analysis.py:124-132)."""
        data_mask = np.concatenate([self._data[name].data_mask
                                    for name in self._corr_items])
        fiducial = np.concatenate(
            [mocks.match_to_data_grid(fiducial_model[name],
                                      self._data[name])
             for name in self._corr_items])
        return data_mask, fiducial

    def create_global_monte_carlo(self, fiducial_model, seed=None,
                                  scale=None, forecast=False):
        """A mock of the masked joint data vector from the global
        covariance (vega_tpu/analysis.py:134-154): fiducial + L @ N(0, 1)
        from the numpy global RNG (seeded with `seed` when given), L the
        Cholesky factor of the masked covariance times `scale`, taken
        once; forecast=True gives the noiseless fiducial."""
        if self._global_cov is None:
            raise ValueError('create_global_monte_carlo requires a global '
                             'covariance matrix.')
        if seed is not None:
            np.random.seed(seed)
        data_mask, fiducial = self._global_mock_pieces(fiducial_model)
        if forecast:
            self.current_mc_mock = fiducial[data_mask]
            return self.current_mc_mock
        if self._cholesky_global_cov is None:
            self._cholesky_global_cov = mocks.scaled_cholesky(
                self._global_cov, 1 if scale is None else scale,
                mask=data_mask)
        self.current_mc_mock = mocks.gaussian_draw(
            fiducial[data_mask], self._cholesky_global_cov)
        return self.current_mc_mock

    def _record_mock(self, mock):
        """Keep a mock: per correlation, or under 'global'
        (vega_tpu/analysis.py:159-164)."""
        if self._global_cov is None:
            for name, cf_mock in mock.items():
                self.mc_mocks.setdefault(name, []).append(cf_mock)
        else:
            self.mc_mocks.setdefault('global', []).append(mock)

    # ------------------------------------------------------------------
    # Serial Monte-Carlo loop
    # ------------------------------------------------------------------
    @staticmethod
    def _fit_one_mock(minimizer, index):
        """Fit the current mock; returns a result record (None marks a
        failed fit, vega_tpu/analysis.py:166-182)."""
        try:
            minimizer.minimize()
        except ValueError:
            print(f'WARNING: Minimizer failed for mock {index}')
            return None
        return {
            'values': minimizer.values,
            'errors': minimizer.errors,
            'cov': np.array(minimizer.covariance),
            'chisq': minimizer.fmin.fval,
            'valid': minimizer.fmin.is_valid,
            'hesse_ok': not minimizer.fmin.hesse_failed,
        }

    def run_monte_carlo(self, fiducial_model, num_mocks=1, seed=0,
                        scale=None, forecast=False, run_mc_fits=True):
        """Sequential generate-and-fit loop with the numpy global RNG
        seeded once with `seed` (vega_tpu/analysis.py:184-239); fits the
        [monte carlo] parameters against whatever the chi^2 reads (the
        mocks once `vega.monte_carlo` is set)."""
        if self.mc_config is None:
            raise ValueError('No Monte Carlo config provided')

        np.random.seed(seed)
        minimizer = Minimizer(
            self._chi2_func, self.mc_config['sample'],
            grad_func=self._grad_func, hess_func=self._hess_func,
            valgrad_func=self._valgrad_func)

        self.mc_mocks = {}
        records = []
        for i in range(num_mocks):
            print(f'INFO: Running Monte Carlo realization {i}')
            sys.stdout.flush()
            create = (self.create_monte_carlo_sim if self._global_cov is None
                      else self.create_global_monte_carlo)
            mock = create(fiducial_model, seed=None, scale=scale,
                          forecast=forecast)
            self._record_mock(mock)
            if run_mc_fits:
                records.append(self._fit_one_mock(minimizer, i))

        self.mc_bestfits = {}
        self.mc_covariances = []
        self.mc_chisq = []
        self.mc_valid_minima = []
        self.mc_valid_hesse = []
        self.mc_failed_mask = []
        for rec in records:
            self.mc_failed_mask.append(rec is None)
            if rec is None:
                self.mc_chisq.append(np.nan)
                self.mc_valid_minima.append(False)
                self.mc_valid_hesse.append(False)
                continue
            for param, value in rec['values'].items():
                self.mc_bestfits.setdefault(param, []).append(
                    [value, rec['errors'][param]])
            self.mc_covariances.append(rec['cov'])
            self.mc_chisq.append(rec['chisq'])
            self.mc_valid_minima.append(rec['valid'])
            self.mc_valid_hesse.append(rec['hesse_ok'])
        if run_mc_fits:
            self.mc_bestfits = {param: np.array(vals)
                                for param, vals in self.mc_bestfits.items()}

        self.has_monte_carlo = True
