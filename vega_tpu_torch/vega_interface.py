"""Main interface: config parsing, per-correlation model construction and
the batched chi^2 / log-likelihood.

Counterpart of vega_tpu/vega_interface.py. Every evaluation is written
out over a leading (B,) axis of parameter points, and dispatches as
vega_tpu does: a call that samples parameters goes through
`get_collapsed(names)`, which gives

- the grid-collapse payload when a grid parameter (ap, at, ...;
  gridcollapse.is_known_grid_param) is sampled: per evaluation, the
  model's coefficient program at the grid reference values and a small
  Chebyshev-interpolated quadratic form (vega_tpu/gridcollapse.py);
- the nuisance-only collapse otherwise: the same quadratic form with
  fixed tensors (vega_tpu/vega_interface.py:288-325,631-657);
- nothing, and then the dense path: model + Hankel transform +
  spline/Legendre + Gaussian chi^2 per row.

The switches are vega_tpu's, read once at construction:
VEGA_TPU_FACTORED=0 takes the dense path for every call, and
VEGA_TPU_GRID_COLLAPSE=0 leaves the grid parameters to the dense path.

The fit (`minimize`, with minimizer.Minimizer) runs on exact derivatives
of the same chi^2 at a point: `chi2_value_and_gradient` and
`chi2_hessian` take torch autograd through whichever path the names
dispatch to (on the dense path through the differentiable spline +
Legendre combine, ops/spline_combine.py). The analysis (scans),
output, plots, Monte-Carlo, global covariance, marginalization and
blinding beyond "none" are not ported yet.
"""

from __future__ import annotations

import configparser
import copy
import os
import os.path
import time

import numpy as np
import scipy.stats
import torch

from . import gridcollapse, utils
from .correlation_item import CorrelationItem
from .data import Data
from .factored import FactoredXi, Sampling, densify
from .io.fits import read_fits
from .minimizer import Minimizer
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
# Rows at a time when every correlation is served by a collapse: a row
# then holds the retained-mode values psi (at most 32 x 32 modes per
# payload block, 8 KB each) and a few (T, T) products, ~20 KB per
# correlation, so 32768 rows take ~1.3 GB.
COLLAPSED_CHUNK_ROWS = 32768
# max|coefficient program - factored model's c0| <= COEFF_RTOL max|c0|,
# checked whenever a collapse is built
COEFF_RTOL = 1e-12


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

        # vega_tpu's switches of the factored path, read once here
        self._factored = os.environ.get('VEGA_TPU_FACTORED', '1') == '1'
        self._grid_collapse = (
            os.environ.get('VEGA_TPU_GRID_COLLAPSE', '1') == '1')
        self._collapsed_cache = {}
        self._collapse_data_cache = {}
        self._grid_cache = {}
        self._device_memo = {}
        # timings and sizes of the last grid-payload build
        # (gridcollapse.build_grid_payload)
        self.grid_stats = {}

        # Minimizer (vega_interface.py:186-194), without vega_tpu's fused
        # value+gradient+Hessian path (VEGA_TPU_FUSED_FIT, off there by
        # default)
        self.minimizer = None
        if self.sample_params['limits']:
            self.minimizer = Minimizer(
                self.chi2, self.sample_params,
                grad_func=self.chi2_gradient, hess_func=self.chi2_hessian,
                valgrad_func=self.chi2_value_and_gradient)

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
        """(model_cf {name: (B, M)}, bad (B,)) for every correlation,
        dense."""
        model_cf = {}
        bad = torch.zeros(n_b, dtype=torch.bool, device=self.device)
        for name in self.corr_items:
            cf, cf_bad = self.models[name].compute(
                local_params, self._pk_full, self._pk_smooth,
                use_kernel=use_kernel)
            model_cf[name] = cf.expand(n_b, -1)
            bad = bad | cf_bad
        return model_cf, bad

    def _chi2_rows(self, local_params, n_b, use_kernel=True, names=(),
                   collapsed=None):
        """chi^2 of B rows (vega_interface.py:374-530): correlations in
        `collapsed` from their quadratic form in the coefficients, every
        other one densely at the true values."""
        if self._chi2_data is None:
            self.set_chi2_constants()
        collapsed = self._device_collapsed(collapsed or {})
        spec = collapsed.get('__grid__')
        sampling = Sampling(frozenset(names)) if self._factored and names \
            else None
        coeff_params = local_params
        if spec is not None:
            tvecs, excess = gridcollapse.grid_tvecs(spec, local_params, n_b)
            # the coefficient program at the grid reference values
            coeff_params = dict(local_params)
            coeff_params.update(zip(spec.names, spec.ref))
        chi2 = torch.zeros(n_b, dtype=DTYPE, device=self.device)
        bad = torch.zeros(n_b, dtype=torch.bool, device=self.device)
        for name in self.corr_items:
            if name in collapsed:
                tensors = collapsed[name]
                coeffs = self.models[name].coefficients(coeff_params, n_b)
                if coeffs.shape[-1] != tensors['cref'].shape[0]:
                    raise AssertionError(
                        'collapsed tensors do not match the factored term '
                        f'structure of {name}')
                if spec is not None:
                    chi2 = chi2 + gridcollapse.grid_corr_chi2(
                        tensors, tvecs, coeffs)
                else:
                    # centered quadratic form (vega_interface.py:491-506)
                    dc = coeffs - tensors['cref']
                    chi2 = chi2 + (tensors['s'] - 2.0 * (dc @ tensors['y'])
                                   + torch.sum(dc * (dc @ tensors['A'].T),
                                               dim=-1))
                continue
            cf, cf_bad = self.models[name].compute(
                local_params, self._pk_full, self._pk_smooth,
                use_kernel=use_kernel, sampling=sampling)
            arrays = self._chi2_data[name]
            model = densify(cf).expand(n_b, -1)
            diff = arrays['data_vec'] - model[:, arrays['model_index']]
            # row-wise diff . (C^-1 diff), as the JAX package orders it
            chi2 = chi2 + torch.sum(diff * (diff @ arrays['inv_cov'].T),
                                    dim=-1)
            bad = bad | cf_bad
        chi2 = chi2 + self._prior_chi2(local_params)
        if spec is not None:
            # smooth wall outside the node domain (GRID_WALL_CHI2)
            chi2 = chi2 + gridcollapse.GRID_WALL_CHI2 * excess
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
    def chi2_batch(self, param_batches, use_kernel=True, chunk_rows=None):
        """chi^2 for a batch: {name: (B,) values} -> (B,) f64 tensor on
        the interface's device, dispatched by the names as vega_tpu does
        (`get_collapsed`). Runs in chunks of `chunk_rows` rows (default
        CHUNK_ROWS, or COLLAPSED_CHUNK_ROWS when every correlation is
        served by a collapse).

        use_kernel=False takes the plain PyTorch spline/Legendre combine
        on a CUDA device for the dense path (for comparing it with the
        kernel)."""
        names = frozenset(param_batches or {})
        collapsed = self.get_collapsed(names)
        local, n_b = self._batch_params(param_batches)
        if chunk_rows is None:
            chunk_rows = (COLLAPSED_CHUNK_ROWS
                          if all(n in collapsed for n in self.corr_items)
                          else CHUNK_ROWS)
        out = torch.empty(n_b, dtype=DTYPE, device=self.device)
        for start in range(0, n_b, chunk_rows):
            stop = min(start + chunk_rows, n_b)
            chunk = {k: (v[start:stop] if isinstance(v, torch.Tensor)
                         and v.shape[0] == n_b > 1 else v)
                     for k, v in local.items()}
            out[start:stop] = self._chi2_rows(chunk, stop - start,
                                              use_kernel, names, collapsed)
        return out

    def log_lik_batch(self, param_batches, chunk_rows=None):
        """(B,) log-likelihood: the normalisation, -chi^2 / 2 and the
        Gaussian priors' normalisations; rows as in `chi2_batch`."""
        chi2 = self.chi2_batch(param_batches, chunk_rows=chunk_rows)
        log_lik = self._log_norm() - 0.5 * chi2
        for prior in self.priors.values():
            log_lik = log_lik + self._gaussian_lik_prior(prior[1])
        return log_lik

    def chi2(self, params=None):
        """Full chi^2 at one parameter point (reference:
        vega_interface.py:250-325): a batch of one."""
        return float(self.chi2_batch(params or {})[0])

    def log_lik(self, params=None):
        """Full log-likelihood (reference: vega_interface.py:327-387): a
        batch of one."""
        return float(self.log_lik_batch(params or {})[0])

    def _log_norm(self):
        """(vega_interface.py:1294-1306, per-correlation covariances)"""
        log_norm = 0.
        for name in self.corr_items:
            log_norm -= 0.5 * self.data[name].data_size * np.log(2 * np.pi)
            log_norm -= 0.5 * self.data[name].log_cov_det
        return log_norm

    # ------------------------------------------------------------------
    # Derivatives (vega_interface.py:883-912,949-975)
    # ------------------------------------------------------------------
    def _chi2_at(self, params, free_names, use_kernel):
        """(chi^2 as a 0-d tensor, {name: leaf}) at one point, dispatched
        by the names of `params` as chi2_batch dispatches them: a 0-d f64
        leaf on the device that requires grad for each of `free_names`,
        the other values as floats; `_chi2_rows` on a batch of one."""
        names = frozenset(params)
        collapsed = self.get_collapsed(names)
        leaves = {name: torch.tensor(float(params[name]), dtype=DTYPE,
                                     device=self.device, requires_grad=True)
                  for name in free_names}
        local, _ = self._batch_params(
            {name: leaves.get(name, float(value))
             for name, value in params.items()})
        chi2 = self._chi2_rows(local, 1, use_kernel, names, collapsed)
        return chi2[0], leaves

    def chi2_value_and_gradient(self, params, use_kernel=True):
        """(chi^2, {name: d chi^2 / d name}) over every key of `params`,
        exact (torch autograd, reverse mode): the minimizer's hot path.
        use_kernel=False takes the plain PyTorch combine on a CUDA device
        (for comparing it with the kernels)."""
        with torch.enable_grad():
            chi2, leaves = self._chi2_at(params, list(params), use_kernel)
            grads = torch.autograd.grad(chi2, list(leaves.values()),
                                        materialize_grads=True)
        return float(chi2.detach()), {name: float(g)
                                      for name, g in zip(leaves, grads)}

    def chi2_gradient(self, params, use_kernel=True):
        """Exact d(chi^2)/d(theta) over every key of `params` (the value
        comes free with it: chi2_value_and_gradient)."""
        return self.chi2_value_and_gradient(params, use_kernel)[1]

    def chi2_hessian(self, params, free_names, use_kernel=True):
        """Exact chi^2 Hessian over free_names, {n1: {n2: value}}, the
        other names of `params` held fixed: reverse over reverse, the
        gradient with its graph (create_graph), then one backward pass per
        free name. Through the combine that is the Functions' double
        backward (ops/spline_combine.py)."""
        free_names = list(free_names)
        with torch.enable_grad():
            chi2, leaves = self._chi2_at(params, free_names, use_kernel)
            free = [leaves[name] for name in free_names]
            grads = torch.autograd.grad(chi2, free, create_graph=True,
                                        materialize_grads=True)
            rows = []
            for grad in grads:
                if not grad.requires_grad:      # chi^2 linear in it
                    rows.append([0.0] * len(free))
                    continue
                row = torch.autograd.grad(grad, free, retain_graph=True,
                                          materialize_grads=True)
                rows.append([float(h) for h in row])
        return {n1: {n2: rows[i][j] for j, n2 in enumerate(free_names)}
                for i, n1 in enumerate(free_names)}

    # ------------------------------------------------------------------
    # The fit (vega_interface.py:1443-1506)
    # ------------------------------------------------------------------
    def minimize(self):
        """Minimize chi^2 over the sampled parameters, then the best-fit
        model, per-correlation chi^2, reduced chi^2 and PTE
        (vega_interface.py:1443-1502). The port has no Monte-Carlo mocks
        or marginalization templates yet (both raise at construction), so
        the data vector is the data and the effective size the masked
        size."""
        if self.minimizer is None:
            print('No sampled parameters. Skipping minimization.')
            return

        self.minimizer.minimize()

        self.bestfit_model = self.compute_model(self.minimizer.values)
        self.total_data_size = 0
        self.bestfit_corr_stats = {}
        num_pars = len(self.sample_params['limits'])

        print('\n----------------------------------------------------')
        for name in self.corr_items:
            corr_data = self.data[name]
            data_size = corr_data.data_size
            self.total_data_size += data_size
            diff = corr_data.masked_data_vec \
                - self.bestfit_model[name][corr_data.model_mask]
            chisq = diff.T.dot(corr_data.inv_masked_cov.dot(diff))
            reduced_chisq = chisq / (data_size - num_pars)
            p_value = 1 - scipy.stats.chi2.cdf(chisq, data_size - num_pars)
            print(f'{name} chi^2/(ndata-nparam): {chisq:.1f}/({data_size}'
                  f'-{num_pars}) = {reduced_chisq:.3f}, PTE={p_value:.2f}')
            print('----------------------------------------------------')
            self.bestfit_corr_stats[name] = {
                'masked_size': data_size, 'chisq': chisq,
                'reduced_chisq': reduced_chisq, 'p_value': p_value,
                'bestfit_marg_coeff': None,
            }

        self.chisq = self.minimizer.fmin.fval
        self.reduced_chisq = self.chisq / (self.total_data_size - num_pars)
        self.p_value = 1 - scipy.stats.chi2.cdf(
            self.chisq, self.total_data_size - num_pars)
        print(f'Total chi^2/(ndata-nparam): {self.chisq:.1f}/'
              f'({self.total_data_size}-{num_pars}) = '
              f'{self.reduced_chisq:.3f}, PTE={self.p_value:.2f}')
        print('----------------------------------------------------\n')
        if not self.minimizer.fmin.is_valid:
            print('Invalid fit!!! Check data, covariance, model and priors.')

    @property
    def bestfit(self):
        return self.minimizer

    @property
    def analysis(self):
        """vega_tpu's Analysis (parameter scans, Monte-Carlo fits)."""
        raise not_ported('Analysis (parameter scans, Monte-Carlo fits)', 8)

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
    # Collapses (vega_interface.py:288-348,563-875)
    # ------------------------------------------------------------------
    def get_collapsed(self, sample_names, with_data_terms=True):
        """Collapse tensors for one sampled-parameter set, cached as host
        numpy (vega_interface.py:563-629): the grid payload when a grid
        parameter is sampled, else the nuisance-only collapse of every
        correlation whose model stays factored, else {} (dense path).
        with_data_terms=False skips the data-side (y, s) terms and gives
        {} for a grid payload, which bakes the data vector in."""
        key = frozenset(sample_names)
        if not key or not self._factored:
            return {}
        grid_names = self._grid_candidate_names(key)
        if grid_names:
            if not with_data_terms:
                return {}
            return self._get_grid_collapsed(key, grid_names)
        if key not in self._collapsed_cache:
            self._collapsed_cache[key] = self._collapsed_graph(key)
        if not with_data_terms:
            return self._collapsed_cache[key]
        return self._with_collapse_data_terms(key,
                                              self._collapsed_cache[key])

    @torch.no_grad()
    def _collapsed_graph(self, key):
        """Basis-collapse pass (vega_interface.py:288-325): per factored
        correlation W = V_m Ci, A = W V_m', the unmasked basis V, the
        coefficients c0 at the current values and m0 = c0 @ V_m; one
        model run on the device, returned as host numpy."""
        if self._chi2_data is None:
            self.set_chi2_constants()
        sampling = Sampling(key)
        out = {}
        for name in self.corr_items:
            cf, _ = self.models[name].compute(
                self.params, self._pk_full, self._pk_smooth,
                sampling=sampling)
            if not isinstance(cf, FactoredXi):
                continue
            fxi = cf.mask(self._chi2_data[name]['model_index'])
            w_mat = fxi.V @ self._chi2_data[name]['inv_cov']
            c0 = fxi.coeff_vector()
            out[name] = {key_: t.cpu().numpy() for key_, t in (
                ('W', w_mat), ('A', w_mat @ fxi.V.T), ('V', cf.V),
                ('c0', c0), ('m0', c0 @ fxi.V))}
        self._check_coefficient_program(
            {name: t['c0'] for name, t in out.items()})
        return out

    def _check_coefficient_program(self, c0s, overrides=()):
        """Raise unless `Model.coefficients`, which restates by hand the
        terms `Model.compute` builds, gives each correlation's factored
        coefficient vector c0 (T,) at the values it was taken at: the
        stored values with `overrides` ((name, value) pairs) in place."""
        local = dict(self.params)
        local.update(overrides)
        for name, c0 in c0s.items():
            got = self.models[name].coefficients(local, 1)[0].cpu().numpy()
            err = (np.max(np.abs(got - c0)) if got.shape == c0.shape
                   else np.inf)
            if not err <= COEFF_RTOL * np.max(np.abs(c0)):
                raise AssertionError(
                    f'the coefficient program of {name} gives {got}, the '
                    f'factored model {c0}')

    def _with_collapse_data_terms(self, key, collapsed):
        """y = W r and s = r' Ci r with r = d - m0 against the data
        vector, host f64 (vega_interface.py:631-657)."""
        if not collapsed:
            return collapsed
        if key not in self._collapse_data_cache:
            merged = {}
            for name, tensors in collapsed.items():
                r = self.data[name].masked_data_vec - tensors['m0']
                inv_cov = np.asarray(self.data[name].inv_masked_cov)
                merged[name] = dict(tensors, y=tensors['W'] @ r,
                                    s=float(r @ (inv_cov @ r)))
            self._collapse_data_cache[key] = merged
        return self._collapse_data_cache[key]

    def use_grid_payload(self, sample_names, payload):
        """Serve `sample_names` from a given grid payload (for example
        one built by vega_tpu and read with gridcollapse.load_payload)
        instead of sweeping: it takes the place of the in-memory entry
        for the current sampling limits."""
        key = frozenset(sample_names)
        grid_names = self._grid_candidate_names(key)
        if tuple(payload['__grid__'].names) != grid_names:
            raise ValueError(f'the payload is over {payload["__grid__"]}, '
                             f'the names sample the grid {grid_names}')
        self._grid_cache[(key, self._limits_key())] = payload

    def _limits_key(self):
        return tuple(sorted(
            (k, tuple(v) if isinstance(v, (tuple, list)) else v)
            for k, v in self.sample_params['limits'].items()))

    def _device_collapsed(self, collapsed):
        """Device copy of a host collapse or grid payload, with the
        per-evaluation arrays only, memoized by payload identity."""
        if not collapsed:
            return collapsed
        memo = self._device_memo.get(id(collapsed))
        if memo is None or memo[0] is not collapsed:
            if '__grid__' in collapsed:
                tensors = gridcollapse.device_payload(collapsed, self.device)
            else:
                tensors = {name: {
                    'A': to_tensor(t['A'], self.device),
                    'cref': to_tensor(t['c0'], self.device),
                    'y': to_tensor(t['y'], self.device),
                    's': float(t['s'])} for name, t in collapsed.items()}
            memo = self._device_memo[id(collapsed)] = (collapsed, tensors)
        return memo[1]

    def coefficient_rows(self, batch, names):
        """The coefficient program of each named correlation at a batch
        of points ({param: float or (P,) array}): {name: (P, T)}."""
        local, n_rows = self._batch_params(
            {k: v for k, v in batch.items() if np.ndim(v)})
        local.update({k: float(v) for k, v in batch.items()
                      if not np.ndim(v)})
        return {name: self.models[name].coefficients(local, n_rows)
                for name in names}

    @torch.no_grad()
    def _grid_collapse_node(self, sample_params, sampled, grid_names,
                            pk_caches):
        """One chunk of the grid-collapse sweep (vega_interface.py:
        327-348): sample_params holds floats, and (C,) node values for
        the grid parameters. Per factored correlation A(g) = W V_m' and
        e(g) = W d with W = V_m Ci as one (C T, n_m) x (n_m, n_m) GEMM,
        and c0. Returns ({name: {'A': (C, T, T), 'e': (C, T)}},
        {name: c0 (T,)}, bad (C,)) on the device. pk_caches keeps each
        model's node-independent power spectra between chunks."""
        if self._chi2_data is None:
            self.set_chi2_constants()
        sampling = Sampling(frozenset(sampled), frozenset(grid_names))
        local = dict(self.params)
        local.update({k: v for k, v in sample_params.items()
                      if not np.ndim(v)})
        nodes, n_c = self._batch_params(
            {k: v for k, v in sample_params.items() if np.ndim(v)})
        local.update({k: nodes[k] for k in grid_names})
        payload, c0s = {}, {}
        bad = torch.zeros(n_c, dtype=torch.bool, device=self.device)
        for name in self.corr_items:
            cf, cf_bad = self.models[name].compute(
                local, self._pk_full, self._pk_smooth, sampling=sampling,
                pk_cache=pk_caches.setdefault(name, {}))
            bad = bad | cf_bad
            if not isinstance(cf, FactoredXi):
                continue
            arrays = self._chi2_data[name]
            fxi = cf.mask(arrays['model_index'])
            n_t, n_m = fxi.V.shape[-2:]
            v_mat = fxi.V.expand(n_c, n_t, n_m)
            w_mat = (v_mat.reshape(n_c * n_t, n_m)
                     @ arrays['inv_cov']).reshape(n_c, n_t, n_m)
            payload[name] = {'A': w_mat @ v_mat.transpose(1, 2),
                             'e': w_mat @ arrays['data_vec']}
            c0s[name] = fxi.coeff_vector()
        return payload, c0s, bad

    def _control_get(self, option, default=None):
        if 'control' in self.main_config:
            return self.main_config['control'].get(option, default)
        return default

    def _grid_candidate_names(self, key):
        """Sampled parameters served by the grid collapse: the known
        nonlinear scale parameters and any [control] grid-params
        (vega_interface.py:711-722)."""
        if not self._grid_collapse:
            return ()
        designated = set((self._control_get('grid-params') or '').split())
        return tuple(n for n in sorted(key)
                     if gridcollapse.is_known_grid_param(n)
                     or n in designated)

    def _grid_dim_setup(self, name):
        """(lo, hi, degree, ref) for one grid dimension
        (vega_interface.py:724-776)."""
        value = float(self.params.get(
            name, 1.0 if name in gridcollapse.ALPHA_LIKE else 0.0))
        override = self._control_get(f'grid-domain-{name}')
        if override is not None:
            lo, hi = (float(v) for v in override.split())
        else:
            limits = self.sample_params['limits'].get(name)
            if limits is None or limits[0] is None or limits[1] is None:
                lo, hi = value - 0.25, value + 0.25
            else:
                lo, hi = float(limits[0]), float(limits[1])
            if (name in gridcollapse.ALPHA_LIKE
                    or name.startswith('alpha_smooth')):
                pad = float(self._control_get(
                    'grid-domain-pad',
                    os.environ.get('VEGA_TPU_GRID_PAD', '0.25')))
                lo, hi = max(lo, value - pad), min(hi, value + pad)
        degree = self._control_get(f'grid-nodes-{name}')
        if degree is None:
            degree = os.environ.get('VEGA_TPU_GRID_NODES')
        if degree is None:
            if (name in gridcollapse.ALPHA_LIKE
                    or name.startswith('alpha_smooth')):
                degree = 32
            elif name.startswith(('drp_', 'sigma_velo_disp_')):
                degree = 12
            else:
                degree = 16
        ref = min(max(value, lo), hi)
        return lo, hi, int(degree), ref

    def _get_grid_collapsed(self, key, grid_names):
        """Grid-collapse payload for one sampled-parameter set, cached in
        memory on the set AND the sampling limits, which the payload
        depends on through measure_dc_max (vega_interface.py:778-875,
        whose key omits the limits). No disk cache yet."""
        cache_key = (key, self._limits_key())
        if cache_key in self._grid_cache:
            return self._grid_cache[cache_key]

        dims = [self._grid_dim_setup(n) for n in grid_names]
        spec = gridcollapse.GridSpec(grid_names, [d[0] for d in dims],
                                     [d[1] for d in dims],
                                     [d[2] for d in dims],
                                     [d[3] for d in dims])
        components = gridcollapse.plan_components(
            spec, mode=self._control_get('grid-combination', 'auto'),
            order=int(self._control_get('grid-interaction-order', 3)))
        sweep_nodes = sum(int(np.prod(degs)) for degs, _ in components)
        max_nodes = int(os.environ.get('VEGA_TPU_GRID_MAX_NODES', 40000))
        if sweep_nodes > max_nodes:
            print(f'INFO: grid collapse disabled: {spec} needs '
                  f'{sweep_nodes} swept nodes > {max_nodes} '
                  '(VEGA_TPU_GRID_MAX_NODES); using the dense path')
            self._grid_cache[cache_key] = {}
            return {}
        mode_budget = self._control_get('grid-mode-budget')
        if mode_budget is None:
            mode_budget = os.environ.get('VEGA_TPU_GRID_MODE_BUDGET', 2e-4)
        t0 = time.perf_counter()
        if self._chi2_data is None:     # host inverse covariances
            self.set_chi2_constants()
        stats = {'constants_s': time.perf_counter() - t0}
        payload = gridcollapse.build_grid_payload(
            self, sorted(key), grid_names, spec,
            svd_tol=float(os.environ.get('VEGA_TPU_GRID_SVD_TOL', 1e-12)),
            mode_budget=float(mode_budget), components=components,
            stats=stats)
        if len(payload) <= 1:       # only '__grid__': nothing factored
            payload = {}
        self._check_coefficient_program(
            {name: p['cref'] for name, p in payload.items()
             if name != '__grid__'}, zip(spec.names, spec.ref))
        self.grid_stats = stats
        self._grid_cache[cache_key] = payload
        return payload

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
