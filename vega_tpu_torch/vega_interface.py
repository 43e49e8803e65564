"""Main interface: config parsing, per-correlation model construction and
the dense batched chi^2 / log-likelihood.

Counterpart of vega_tpu/vega_interface.py for the dense regime
(VEGA_TPU_FACTORED=0 there): every evaluation runs model + Hankel
transform + spline/Legendre + Gaussian chi^2 for a batch of parameter
points, written out over a leading (B,) axis. The minimizer, analysis,
output, plots, Monte-Carlo, global covariance, marginalization and
blinding beyond "none" are not ported yet.
"""

from __future__ import annotations

import configparser
import copy
import os.path

import numpy as np
import torch

from . import utils
from .correlation_item import CorrelationItem
from .data import Data
from .io.fits import read_fits
from .model import Model
from .parameters.param_utils import get_default_values
from .scale_parameters import ScaleParameters
from .utils import DTYPE, not_ported, to_tensor

PENALTY_CHI2 = 1e100

# chi2_batch evaluates at most this many rows at a time. Each row holds,
# per correlation, up to three (1000 mu_k x 814 k) f64 grids at once
# (pk_peak, pk_smooth and one product temporary): 3 x 6.51 MB = 19.5 MB.
# Correlations run one after the other, so 1024 rows need ~20 GB, and a
# batch of 8192 runs as 8 chunks well inside an 80 GB card.
CHUNK_ROWS = 1024


def parse_ini(path):
    """Case-preserving INI parser (reference: vega_interface.py:51-53)."""
    config = configparser.ConfigParser()
    config.optionxform = lambda option: option
    config.read(utils.find_file(os.path.expandvars(str(path))))
    return config


def resolve_device(device):
    """torch.device for `device`; asking for CUDA without a GPU raises
    (the port never carries on on the CPU instead)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but torch finds no '
                           'CUDA device')
    return device


class VegaInterface:
    """Main interface (reference: vega_interface.py:22-206).

    `device` is required: 'cpu', 'cuda' or 'cuda:N'.
    """

    def __init__(self, main_path, device):
        self.device = resolve_device(device)
        # f64 throughout; state the TF32 policy explicitly all the same
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.main_config = parse_ini(main_path)
        if 'monte carlo' in self.main_config:
            raise not_ported('Monte-Carlo', 8)

        self.fiducial = self._read_fiducial(self.main_config['fiducial'])
        self.fiducial['z_eff'] = self.main_config['data sets'].getfloat('zeff')
        ini_files = self.main_config['data sets'].get('ini files').split()
        if self.main_config['data sets'].get('global-cov-file', None):
            raise not_ported('Global covariance', 10)

        control = (self.main_config['control']
                   if 'control' in self.main_config else {})
        if control and control.getboolean('model_pk', False):
            raise not_ported('model_pk', 10)
        if control and control.getboolean('marginalize-in-fit', False):
            raise not_ported('marginalize-in-fit', 10)

        self.corr_items = {}
        for path in ini_files:
            config = parse_ini(path)
            name = config['data'].get('name')
            self.corr_items[name] = CorrelationItem(config)

        self.params = self._read_parameters(self.corr_items,
                                            self.main_config['parameters'])
        self.sample_params = self._read_sample(self.main_config['sample'])

        # Growth rate handling (reference: vega_interface.py:90-107)
        use_template_growth = True
        if control:
            use_template_growth = control.getboolean(
                'use_template_growth_rate', True)
        if use_template_growth and 'growth_rate' in self.fiducial:
            if 'growth_rate' in self.sample_params['limits']:
                raise ValueError(
                    'use_template_growth_rate is True, but growth_rate is '
                    'sampled. Remove it from [sample] or set '
                    'use_template_growth_rate = False.')
            self.params['growth_rate'] = self.fiducial['growth_rate']
        elif 'growth_rate' not in self.fiducial:
            if 'growth_rate' in self.params:
                self.fiducial['growth_rate'] = self.params['growth_rate']

        if not all(item.has_data for item in self.corr_items.values()):
            raise not_ported('Correlations without a data file', 10)
        self.data = {name: Data(item)
                     for name, item in self.corr_items.items()}

        self.scale_params = ScaleParameters(self.main_config['cosmo-fit type'])

        self.models = {name: Model(item, self.fiducial, self.scale_params,
                                   self.data[name], device=self.device)
                       for name, item in self.corr_items.items()}

        self.priors = {}
        if 'priors' in self.main_config:
            self.priors = self._init_priors(self.main_config['priors'])
            for param in self.priors:
                if param not in self.sample_params['limits']:
                    raise ValueError('Prior specified for a parameter that '
                                     f'is not sampled: {param}')

        self.set_fiducial_pk(self.fiducial['pk_full'],
                             self.fiducial['pk_smooth'])
        # chi^2-side device constants, built at the first chi^2 (the
        # inverse covariances are the costly part of init; model-only
        # users such as make_synthetic_dataset never need them)
        self._chi2_data = None

    def set_fiducial_pk(self, pk_full, pk_smooth):
        """Install the fiducial linear spectra (host arrays)."""
        self.fiducial['pk_full'] = np.asarray(pk_full, dtype=np.float64)
        self.fiducial['pk_smooth'] = np.asarray(pk_smooth, dtype=np.float64)
        self._pk_full = to_tensor(pk_full, self.device)
        self._pk_smooth = to_tensor(pk_smooth, self.device)

    def set_chi2_constants(self):
        """Copy the chi^2-side host arrays of `self.data` (masked inverse
        covariance, masked data vector, model mask) to the device."""
        self._chi2_data = {}
        for name, d in self.data.items():
            self._chi2_data[name] = {
                'inv_cov': to_tensor(d.inv_masked_cov, self.device),
                'data_vec': to_tensor(d.masked_data_vec, self.device),
                'model_index': torch.as_tensor(
                    np.flatnonzero(d.model_mask), dtype=torch.int64,
                    device=self.device),
            }

    # ------------------------------------------------------------------
    # Batched model + chi^2
    # ------------------------------------------------------------------
    def _batch_params(self, params):
        """Local parameter dict: the stored floats, overridden by `params`
        as (B,) f64 tensors on the device. Returns (dict, B)."""
        local = copy.copy(self.params)
        for name, value in (params or {}).items():
            local[name] = torch.as_tensor(value, dtype=DTYPE,
                                          device=self.device).reshape(-1)
        sizes = {local[name].shape[0] for name in (params or {})}
        n_b = max(sizes, default=1)
        if not sizes <= {1, n_b}:
            raise ValueError(f'parameter batches of different lengths: '
                             f'{sorted(sizes)}')
        return local, n_b

    def _model_graph(self, local_params, n_b, use_kernel=True):
        """(model_cf {name: (B, M)}, bad (B,)) for every correlation."""
        model_cf = {}
        bad = torch.zeros(n_b, dtype=torch.bool, device=self.device)
        for name in self.corr_items:
            cf, cf_bad = self.models[name].compute(
                local_params, self._pk_full, self._pk_smooth,
                use_kernel=use_kernel)
            model_cf[name] = cf.expand(n_b, -1)
            bad = bad | cf_bad
        return model_cf, bad

    def _chi2_rows(self, local_params, n_b, use_kernel=True):
        """chi^2 of B rows (vega_interface.py:374-530, dense path)."""
        if self._chi2_data is None:
            self.set_chi2_constants()
        model_cf, bad = self._model_graph(local_params, n_b, use_kernel)
        chi2 = torch.zeros(n_b, dtype=DTYPE, device=self.device)
        for name in self.corr_items:
            arrays = self._chi2_data[name]
            diff = arrays['data_vec'] - model_cf[name][:, arrays['model_index']]
            # row-wise diff . (C^-1 diff), as the JAX package orders it
            chi2 = chi2 + torch.sum(diff * (diff @ arrays['inv_cov'].T),
                                    dim=-1)
        chi2 = chi2 + self._prior_chi2(local_params)
        return torch.where(bad, PENALTY_CHI2, chi2)

    def _prior_chi2(self, local_params):
        """(vega_interface.py:545-554)"""
        chi2 = 0.
        for param, prior in self.priors.items():
            if param not in local_params:
                raise AssertionError(
                    'You have specified a prior for a parameter not in the '
                    f'model. Offending parameter: {param}')
            chi2 = chi2 + ((local_params[param] - prior[0]) ** 2
                           / prior[1] ** 2)
        return chi2

    # ------------------------------------------------------------------
    # Public API (mirrors vega_tpu)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def chi2_batch(self, param_batches, use_kernel=True):
        """chi^2 for a batch: {name: (B,) values} -> (B,) f64 tensor on
        the interface's device. Runs in chunks of CHUNK_ROWS rows.

        use_kernel=False takes the plain PyTorch spline/Legendre combine
        on a CUDA device (for comparing it with the kernel)."""
        local, n_b = self._batch_params(param_batches)
        out = torch.empty(n_b, dtype=DTYPE, device=self.device)
        for start in range(0, n_b, CHUNK_ROWS):
            stop = min(start + CHUNK_ROWS, n_b)
            chunk = {k: (v[start:stop] if isinstance(v, torch.Tensor)
                         and v.shape[0] == n_b > 1 else v)
                     for k, v in local.items()}
            out[start:stop] = self._chi2_rows(chunk, stop - start,
                                              use_kernel)
        return out

    def log_lik_batch(self, param_batches):
        chi2 = self.chi2_batch(param_batches)
        log_lik = self._log_norm() - 0.5 * chi2
        for prior in self.priors.values():
            log_lik = log_lik + self._gaussian_lik_prior(prior[1])
        return log_lik

    def chi2(self, params=None):
        """Full chi^2 at one parameter point (reference:
        vega_interface.py:250-325): a batch of one."""
        return float(self.chi2_batch(params or {})[0])

    def log_lik(self, params=None):
        """Full log-likelihood (reference: vega_interface.py:327-387)."""
        log_lik = self._log_norm() - 0.5 * self.chi2(params)
        for prior in self.priors.values():
            log_lik += self._gaussian_lik_prior(prior[1])
        return log_lik

    def _log_norm(self):
        """(vega_interface.py:1294-1306, per-correlation covariances)"""
        log_norm = 0.
        for name in self.corr_items:
            log_norm -= 0.5 * self.data[name].data_size * np.log(2 * np.pi)
            log_norm -= 0.5 * self.data[name].log_cov_det
        return log_norm

    @torch.no_grad()
    def compute_model(self, params=None, use_kernel=True):
        """Model correlations at one point as numpy arrays
        (vega_interface.py:1015-1099); raises VegaModelError where the
        chi^2 would take the penalty."""
        local, _ = self._batch_params(params)
        model_cf, bad = self._model_graph(local, 1, use_kernel)
        if bool(bad.any()):
            raise utils.VegaModelError(
                'Model evaluation failed (out-of-bounds interpolation)')
        return {name: cf[0].cpu().numpy() for name, cf in model_cf.items()}

    # ------------------------------------------------------------------
    # Config readers (reference: vega_interface.py:666-851)
    # ------------------------------------------------------------------
    @staticmethod
    def _read_fiducial(fiducial_config):
        path = fiducial_config.get('filename')
        path = utils.find_file(os.path.expandvars(path))
        print(f'INFO: reading input Pk {path}')
        hdul = read_fits(path)
        fiducial = {
            'z_fiducial': hdul[1].header['ZREF'],
            'Omega_m': hdul[1].header['OM'],
            'Omega_de': hdul[1].header['OL'],
            'k': hdul[1]['K'].astype(np.float64),
            'pk_full': hdul[1]['PK'].astype(np.float64),
            'pk_smooth': hdul[1]['PKSB'].astype(np.float64),
        }
        if 'F_ZREF' in hdul[1].header:
            fiducial['growth_rate'] = hdul[1].header['F_ZREF']
        return fiducial

    @staticmethod
    def _read_parameters(corr_items, parameters_config):
        params = {}
        for corr_item in corr_items.values():
            if 'parameters' in corr_item.config:
                for param, value in corr_item.config.items('parameters'):
                    params[param] = float(value)
        for param, value in parameters_config.items():
            params[param] = float(value)
        return params

    def _read_sample(self, sample_config):
        """(vega_interface.py:1722-1768)"""
        sample_params = {'limits': {}, 'values': {}, 'errors': {}, 'fix': {}}
        default_values = get_default_values()

        def check_param(param):
            if param not in default_values:
                raise ValueError(f'Default values not found for: {param}. '
                                 'Add them to default_values.txt or provide '
                                 'the full sampling specification.')

        for param, values in sample_config.items():
            if param not in self.params:
                print(f'Warning: sampled parameter {param} was not '
                      'specified under [parameters]; it will be skipped.')
                continue
            values_list = values.split()

            if len(values_list) > 1:
                lower = (None if values_list[0] == 'None'
                         else float(values_list[0]))
                upper = (None if values_list[1] == 'None'
                         else float(values_list[1]))
                sample_params['limits'][param] = (lower, upper)
            else:
                if values_list[0] not in ['True', 'true', 't', 'y', 'yes']:
                    continue
                check_param(param)
                sample_params['limits'][param] = \
                    default_values[param]['limits']

            if len(values_list) > 2:
                sample_params['values'][param] = float(values_list[2])
            else:
                check_param(param)
                sample_params['values'][param] = self.params[param]

            if len(values_list) > 3:
                if len(values_list) != 4:
                    raise ValueError(f'Bad [sample] entry for {param}')
                sample_params['errors'][param] = float(values_list[3])
            else:
                check_param(param)
                sample_params['errors'][param] = default_values[param]['error']

            sample_params['fix'][param] = False
        return sample_params

    @staticmethod
    def _gaussian_lik_prior(sigma):
        return -0.5 * np.log(2 * np.pi) - np.log(sigma)

    @staticmethod
    def _init_priors(prior_config):
        """(vega_interface.py:1778-1790)"""
        prior_dict = {}
        for param, prior in prior_config.items():
            prior_list = prior.split()
            if len(prior_list) != 3:
                raise ValueError('Prior format: "<param> = gaussian <mean> '
                                 '<sigma>"')
            if prior_list[0] not in ['gaussian', 'Gaussian']:
                raise ValueError('Only gaussian priors are supported.')
            prior_dict[param] = np.array(prior_list[1:]).astype(float)
        return prior_dict
