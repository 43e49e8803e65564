"""Results output: FITS (and HDF5) writers.

Counterpart of vega_tpu/output.py:19-273 with the same file layout
(MODEL_* HDUs, BESTFIT, the model components' PK_ / Xi_ HDUs with
[output] write_pk / write_cf, SCAN, Monte-Carlo outputs), so either
package's FitResults and FITS reader read the other's files
(tests/test_torch_output.py, test_torch_components.py). Written through
the port's pure-numpy FITS writer; h5py is imported only by
`write_results_hdf`.
"""

from __future__ import annotations

import os.path
from pathlib import Path

import numpy as np

from .io.fits import write_fits


class Output:
    """(vega_tpu/output.py:19-31)"""

    def __init__(self, config, data, corr_items, analysis=None):
        self.data = data
        self.analysis = analysis
        self.corr_items = corr_items
        self.type = config.get('type', 'fits')
        self.overwrite = config.getboolean('overwrite', False)
        self.outfile = os.path.expandvars(config['filename'])
        self.output_cf = config.getboolean('write_cf', False)
        self.output_pk = config.getboolean('write_pk', False)
        self.mc_output = config.get('mc_output', None)

    def write_results(self, corr_funcs, params, minimizer=None,
                      bestfit_corr_stats=None, scan_results=None,
                      models=None):
        """(vega_tpu/output.py:33-43); `models` ({name: Model}) carry the
        saved components the PK_ / Xi_ HDUs hold."""
        if self.type == 'fits':
            self.write_results_fits(corr_funcs, params, minimizer,
                                    bestfit_corr_stats, scan_results, models)
        elif self.type in ('hdf', 'h5'):
            self.write_results_hdf(minimizer, scan_results)
        else:
            raise ValueError('Unknown output type. Set type = fits or hdf')

    @staticmethod
    def pad_array(array, size_to_match, pad_value=np.nan):
        return np.pad(np.asarray(array, dtype=float),
                      (0, size_to_match - len(array)),
                      constant_values=pad_value)

    def write_results_fits(self, corr_funcs, params, minimizer=None,
                           bestfit_corr_stats=None, scan_results=None,
                           models=None):
        """MODEL_* HDUs, BESTFIT, PK_* / Xi_* and SCAN in
        `<filename>.fits` (vega_tpu/output.py:51-76)."""
        if self.data is None:
            raise ValueError('Output initialized without a valid data object')

        hdus = self._model_hdus(corr_funcs, params, bestfit_corr_stats)
        if minimizer is not None:
            hdus.append(self._bestfit_hdu(minimizer))
        if (self.output_pk or self.output_cf) and models is None:
            raise ValueError('[output] write_pk / write_cf write the saved '
                             'components of the models: pass models')
        if self.output_pk:
            for key, model in models.items():
                hdus.append(self._component_hdu(f'PK_{key}', model.pk))
        if self.output_cf:
            for key, model in models.items():
                hdus.append(self._cf_hdu(key, model))
        if scan_results is not None:
            assert minimizer is not None
            hdus.append(self._scan_hdu(scan_results))

        outfile = self.outfile
        if outfile[-5:] != '.fits':
            outfile += '.fits'
        write_fits(Path(outfile), hdus, overwrite=True)

    def _model_hdus(self, corr_funcs, params, bestfit_corr_stats=None):
        """MODEL_* HDUs (vega_tpu/output.py:78-133)."""
        model_hdus = []
        for name, cf in corr_funcs.items():
            num_rows = len(cf)
            if len(self.data[name].data_vec) > num_rows:
                raise ValueError(
                    'Data coordinate grid is larger than the model grid.')

            coords_dist = self.corr_items[name].dist_model_coordinates
            coords_model = self.corr_items[name].model_coordinates
            columns = {
                name + '_MODEL': self.pad_array(cf, num_rows),
                name + '_MODEL_MASK': np.pad(
                    self.data[name].model_mask,
                    (0, num_rows - len(self.data[name].model_mask)),
                    constant_values=False),
                name + '_MASK': np.pad(
                    self.data[name].data_mask,
                    (0, num_rows - len(self.data[name].data_mask)),
                    constant_values=False),
                name + '_DATA': self.pad_array(self.data[name].data_vec,
                                               num_rows),
                name + '_VAR': self.pad_array(self.data[name].variance,
                                              num_rows),
                name + '_RP': self.pad_array(coords_dist.rp_grid, num_rows),
                name + '_RT': self.pad_array(coords_dist.rt_grid, num_rows),
            }
            if num_rows < coords_model.z_grid.size:
                columns[name + '_Z'] = np.zeros(num_rows)
            else:
                columns[name + '_Z'] = self.pad_array(coords_model.z_grid,
                                                      num_rows)
            if self.data[name].nb is not None:
                columns[name + '_NB'] = np.pad(
                    self.data[name].nb,
                    (0, num_rows - len(self.data[name].nb)),
                    constant_values=0)

            header = {}
            for par, val in params.items():
                header[self._short_key(par)] = float(val)
            if bestfit_corr_stats is not None:
                for par, val in bestfit_corr_stats[name].items():
                    if par == 'bestfit_marg_coeff':
                        if val is None:
                            continue
                        for i, v in enumerate(val):
                            header[self._short_key(f'marg_coeff_{i}')] = \
                                float(v)
                    else:
                        header[self._short_key(par)] = float(val)

            model_hdus.append({'name': 'MODEL_' + name, 'header': header,
                               'columns': columns})
        return model_hdus

    @staticmethod
    def _short_key(par):
        """FITS header keys are limited to 8 chars in the minimal writer;
        long parameter names are stored via HIERARCH-like truncation."""
        return par if len(par) <= 8 else par[:8]

    def _bestfit_hdu(self, minimizer):
        """BESTFIT HDU (vega_tpu/output.py:141-162)."""
        names = np.array(list(minimizer.values.keys()))
        values = np.array([minimizer.values[name] for name in names])
        errors = np.array([minimizer.errors[name] for name in names])
        cov_mat = np.array(minimizer.covariance)

        header = {
            'FVAL': float(minimizer.fmin.fval),
            'VALID': bool(minimizer.minuit.valid),
            'ACCURATE': bool(minimizer.minuit.accurate),
        }
        if np.isfinite(minimizer.fmin.edm):
            header['EDM'] = float(minimizer.fmin.edm)
        return {
            'name': 'BESTFIT',
            'header': header,
            'columns': {
                'names': names, 'values': values, 'errors': errors,
                'covariance': cov_mat,
            },
        }

    def _scan_hdu(self, scan_results):
        """SCAN HDU (vega_tpu/output.py:164-179)."""
        names = list(scan_results[0].keys())
        results = np.array([[res[par] for par in names]
                            for res in scan_results])
        columns = {'names': np.array(names)}
        for col, name in zip(results.T, names):
            columns[name] = col

        header = {}
        if self.analysis is not None and hasattr(self.analysis, 'grids'):
            for par, grid in self.analysis.grids.items():
                header[self._short_key(par + '_min')] = float(grid[0])
                header[self._short_key(par + '_max')] = float(grid[-1])
                header[self._short_key(par + '_nbin')] = len(grid)
        return {'name': 'SCAN', 'header': header, 'columns': columns}

    def _cf_hdu(self, component, model):
        """Xi_<name>: the raw and distorted xi components
        (vega_tpu/output.py:181-185)."""
        columns = {}
        columns.update(self._get_components(model.xi, 'raw_'))
        columns.update(self._get_components(model.xi_distorted, 'distorted_'))
        return {'name': 'Xi_' + component, 'columns': columns}

    def _component_hdu(self, name, model_components):
        return {'name': name, 'columns': self._get_components(model_components)}

    @staticmethod
    def _get_components(model_components, name_prefix=''):
        """Saved components as table columns, `<part>_core` and
        `<part>_<name1>_<name2>` per metal pair (vega_tpu/output.py:
        190-204)."""
        columns = {}
        for part, data in model_components.items():
            if not data:
                continue
            for key, item in data.items():
                if key == 'core':
                    cname = name_prefix + part + '_core'
                else:
                    cname = name_prefix + part + '_' + key[0] + '_' + key[1]
                columns[cname] = np.atleast_1d(np.asarray(item))
        return columns

    def write_monte_carlo(self, cpu_id=None):
        """Monte-Carlo outputs: Bestfit, FitInfo and Mocks in
        monte_carlo[_<cpu_id>].fits (vega_tpu/output.py:206-248)."""
        assert self.analysis is not None
        assert self.analysis.has_monte_carlo, (
            'No Monte Carlo results found. Run run_monte_carlo() first.')

        hdus = []
        bestfits = self.analysis.mc_bestfits
        covariances = np.array(self.analysis.mc_covariances)

        if bestfits:
            names = np.array(list(bestfits.keys()))
            bestfit_table = np.array([bestfits[name][:, 0] for name in names])
            errors_table = np.array([bestfits[name][:, 1] for name in names])
            covariances = covariances.reshape(
                bestfit_table.shape[1] * len(names), len(names)).T

            hdus.append({'name': 'Bestfit', 'columns': {
                'names': names, 'values': bestfit_table,
                'errors': errors_table, 'covariance': covariances}})
            hdus.append({'name': 'FitInfo', 'columns': {
                'chisq': np.array(self.analysis.mc_chisq),
                'valid_minima': np.array(self.analysis.mc_valid_minima,
                                         dtype=bool),
                'valid_hesse': np.array(self.analysis.mc_valid_hesse,
                                        dtype=bool),
                'failed_mask': np.array(self.analysis.mc_failed_mask,
                                        dtype=bool)}})
        else:
            print('No MC bestfit data to write.')

        mock_cols = {name: np.array(m)
                     for name, m in self.analysis.mc_mocks.items()}
        hdus.append({'name': 'Mocks', 'columns': mock_cols})

        if self.mc_output is None:
            dir_path = Path(self.outfile).parent / 'monte_carlo'
        else:
            dir_path = Path(self.mc_output)
        dir_path.mkdir(parents=True, exist_ok=True)
        filename = ('monte_carlo.fits' if cpu_id is None
                    else f'monte_carlo_{cpu_id}.fits')
        write_fits(dir_path / filename, hdus, overwrite=True)

    def write_results_hdf(self, minimizer, scan_results=None):
        """Legacy HDF5 output (vega_tpu/output.py:250-273)."""
        import h5py
        if minimizer is None:
            raise ValueError('The hdf output format requires minimization')
        with h5py.File(Path(self.outfile), 'w') as h5_file:
            bf_group = h5_file.create_group('best fit')
            for param, value in minimizer.values.items():
                bf_group.attrs[param] = (value, minimizer.errors[param])
            for (par1, par2), cov in minimizer.covariance.items():
                bf_group.attrs[f'cov[{par1}, {par2}]'] = cov
            for item, value in minimizer.fmin.items():
                bf_group.attrs[item] = value

            if scan_results is not None:
                scan_group = h5_file.create_group('chi2 scan')
                params = list(scan_results[0].keys())
                results = np.array([[res[par] for par in params]
                                    for res in scan_results])
                for i, par in enumerate(params):
                    scan_group.attrs[par] = i
                values = scan_group.create_dataset(
                    'values', np.shape(results), dtype='f')
                values[...] = results
