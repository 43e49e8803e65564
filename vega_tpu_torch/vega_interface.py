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

A configuration may carry metals (from metal files or, in the
new-metals mode, matrices computed from the stacked-delta weights;
metals.py), an HCD model, a small-scale non-linear term, the QSO
radiation and the DESI instrumental systematics: their sampled biases,
betas and amplitudes enter the factored model as coefficients, so the
grid and nuisance collapses serve them too.

A joint (global) covariance over the concatenated correlations
([data sets] global-cov-file, `read_global_cov`) replaces the
per-correlation ones: the chi^2 is then d' C^-1 d over the concatenated
masked model, and every call is served densely, as vega_tpu serves it
(no collapse, no grid payload).

The switches are vega_tpu's, read once at construction:
VEGA_TPU_FACTORED=0 takes the dense path for every call, and
VEGA_TPU_GRID_COLLAPSE=0 leaves the grid parameters to the dense path.

The fit (`minimize`, with minimizer.Minimizer) runs on exact derivatives
of the same chi^2 at a point: `chi2_value_and_gradient` and
`chi2_hessian` take torch autograd through whichever path the names
dispatch to (on the dense path through the differentiable spline +
Legendre combine, ops/spline_combine.py); `chi2_batch_derivatives`
gives the same for B independent rows, which the batched Newton of
parallel/batch.py (profile scans, Monte-Carlo mock fits) runs on. The
chi^2 is taken against the current data vectors: the data, or after
`initialize_monte_carlo` the Monte-Carlo mock (of the joint data vector
under a global covariance). The `run_sampler` and `sampler` flags of
[control] name the sampler scripts/run_vega_sampler.py runs (samplers/).

A grid payload is kept on disk under its content fingerprint
(gridcollapse.payload_fingerprint, in VEGA_TPU_GRID_CACHE_DIR, default
~/.cache/vega_tpu_torch_grid; VEGA_TPU_GRID_CACHE=0 turns it off), so a
later process of the same fit loads it instead of sweeping; an
interrupted sweep resumes from its part files. A fit's results are
written by `output` (output.Output: FITS or HDF5, read back with
postprocess.FitResults), with the model's components (PK_ / Xi_ HDUs)
when [output] sets write_pk or write_cf: the models then keep the
components of every `compute_model` (save-components, model.py).
`plots` (plots.plot.VegaPlots, matplotlib) is built at first use, so an
interface constructs where matplotlib is not installed.

Fisher sensitivity per (rp, rt) bin (vega_interface.py:1508-1688):
`compute_sensitivity` by central differences of the saved components,
one rebuilt model per step; `compute_sensitivity_exact` from exact
partials of vega_tpu's component graph, forward-mode columns taken as
one double backward (`_component_jacobian`).

Small-scale marginalization (the [model] marginalize-* options of a
correlation, data.py): by default the templates enter the covariance
(its update, made once on the host), and every path runs on that
covariance's masked inverse. With [control] marginalize-in-fit = True
the covariance stays as read and each evaluation fits the templates to
its residual instead: coefficients D2C (d - m[mask]) per row, the model
plus T . coefficients (vega_interface.py:441-447,532-544); every such
call is dense, as in vega_tpu. `chi2` / `log_lik` with
return_marg_coeff=True, `compute_marg_coeff` and the fit's
`bestfit_corr_stats` give the coefficients; `corr_num_marg_modes` the
modes per correlation, the samplers' derived columns.

Blinding beyond "none" is not ported yet.
"""

from __future__ import annotations

import configparser
import copy
import os
import os.path
import shutil
import time

import numpy as np
import scipy.stats
import torch

from . import gridcollapse, utils
from .analysis import Analysis
from .correlation_item import CorrelationItem
from .data import Data
from .factored import FactoredXi, Sampling, densify
from .io.fits import read_fits
from .minimizer import Minimizer
from .model import Model
from .output import Output
from .parameters.param_utils import get_default_values
from .scale_parameters import ScaleParameters
from .utils import not_ported, refuse_f32, resolve_dtype, to_tensor

PENALTY_CHI2 = 1e100


def penalty_chi2(dtype):
    """The chi^2 of a penalised row in `dtype`: 1e100, which is inf in
    f32, as vega_tpu's jnp.where(bad, 1e100, chi2) gives it under
    VEGA_TPU_X64=0 (torch refuses to round 1e100 to f32 itself)."""
    return PENALTY_CHI2 if dtype == torch.float64 else float('inf')

# chi2_batch evaluates at most this many rows at a time. Each row holds,
# per correlation, up to three (1000 mu_k x 814 k) f64 grids at once
# (pk_peak, pk_smooth and one product temporary): 3 x 6.51 MB = 19.5 MB.
# Correlations run one after the other, so 1024 rows need ~20 GB, and a
# batch of 8192 runs as 8 chunks well inside an 80 GB card. With an HCD
# model the Kaiser term is a (mu_k, k) grid per row as well: the
# DR16-shaped configuration peaked at 28.79 GB at this chunk (chip_smoke.py,
# NVIDIA H100 80GB HBM3, 700.00 W).
CHUNK_ROWS = 1024
# Rows at a time when every correlation is served by a collapse: a row
# then holds the retained-mode values psi (at most 32 x 32 modes per
# payload block, 8 KB each) and a few (T, T) products, ~20 KB per
# correlation, so 32768 rows take ~1.3 GB; with metals T is 60 instead of
# 6 and a row's (T, T) block 29 KB: 4.23 GB at 32768 rows (chip_smoke.py,
# NVIDIA H100 80GB HBM3, 700.00 W).
COLLAPSED_CHUNK_ROWS = 32768
# max|coefficient program - factored model's c0| <= COEFF_RTOL max|c0|,
# checked whenever a collapse is built
COEFF_RTOL = 1e-12


def quadratic_rows(diff, inv_cov):
    """Row-wise diff . (C^-1 diff) of (B, n) rows: one (B, n) x (n, n)
    GEMM and a row-wise dot, as the JAX package orders it."""
    return torch.sum(diff * (diff @ inv_cov.T), dim=-1)


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

    `device` is required: 'cpu', 'cuda' or 'cuda:N'. `dtype` is the
    device dtype of every model and chi^2 tensor: torch.float64 (the
    parity mode) or torch.float32 (vega_tpu's f32 throughput mode); None
    reads VEGA_TPU_X64 as vega_tpu does ('0': f32, else f64). Host numpy
    stays f64 in both: the inverse covariances, FFTLog and spline
    operators are built in f64 and cast once onto the device. The f32
    mode covers synthetic-full's model (Kaiser, the peak's broadening,
    G(k), the Lorentzian velocity dispersion), dense and through the grid
    collapse, and the fit; every other feature raises `not_ported` at
    construction (ROADMAP.md item 10), never running in f64 instead.
    """

    def __init__(self, main_path, device, dtype=None):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        # TF32 off: f32 products are true f32 and f64 ones are untouched
        # by it (stated explicitly all the same)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.main_config = parse_ini(main_path)

        self.fiducial = self._read_fiducial(self.main_config['fiducial'])
        self.fiducial['z_eff'] = self.main_config['data sets'].getfloat('zeff')
        # the models keep their components (vega_interface.py:62-65)
        output = self.main_config['output']
        self.fiducial['save-components'] = (
            output.getboolean('write_cf', False)
            or output.getboolean('write_pk', False))
        ini_files = self.main_config['data sets'].get('ini files').split()
        global_cov_file = self.main_config['data sets'].get(
            'global-cov-file', None)

        control = (self.main_config['control']
                   if 'control' in self.main_config else {})
        # with a global covariance the per-correlation ones need not be
        # held (vega_interface.py:74-76)
        self.low_mem_mode = (bool(control)
                             and control.getboolean('low_mem_mode', False)
                             and global_cov_file is not None)
        if control and control.getboolean('model_pk', False):
            raise not_ported('model_pk', 5)
        # the templates fitted per evaluation instead of entering the
        # covariance (vega_interface.py:77-79)
        self.marginalize_in_fit = (
            bool(control) and control.getboolean('marginalize-in-fit', False))
        for feature, on in (
                ('marginalize-in-fit', self.marginalize_in_fit),
                ('a global covariance', global_cov_file is not None),
                ('the samplers', bool(control)
                 and control.getboolean('run_sampler', False)),
                ('Monte-Carlo', 'monte carlo' in self.main_config)):
            if on:
                refuse_f32(self.dtype, feature)

        self.corr_items = {}
        for path in ini_files:
            config = parse_ini(path)
            name = config['data'].get('name')
            self.corr_items[name] = CorrelationItem(config)
            self.corr_items[name].low_mem_mode = self.low_mem_mode
            # before the data layer reads their files
            for feature in ('metals', 'broadband'):
                if feature in config:
                    refuse_f32(self.dtype, feature)
            if self.corr_items[name].marginalize_small_scales:
                refuse_f32(self.dtype, 'Small-scale marginalization')

        self.params = self._read_parameters(self.corr_items,
                                            self.main_config['parameters'])
        self.sample_params = self._read_sample(self.main_config['sample'])
        # the config's sampling limits: limits changed after construction
        # change the grid payload (measure_dc_max) and are folded into its
        # fingerprint (vega_interface.py:104-112)
        self._config_limits = self._limits_dict()

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
            raise not_ported('Correlations without a data file', 5)
        self.data = {name: Data(item,
                                marginalize_in_fit=self.marginalize_in_fit)
                     for name, item in self.corr_items.items()}

        self.scale_params = ScaleParameters(self.main_config['cosmo-fit type'])

        self._build_models()

        # Monte Carlo config (vega_interface.py:157-164)
        self.mc_config = None
        if 'monte carlo' in self.main_config:
            self.mc_config = {'params': {}}
            for param, value in self.main_config['mc parameters'].items():
                self.mc_config['params'][param] = float(value)
            self.mc_config['sample'] = self._read_sample(
                self.main_config['monte carlo'])

        self.priors = {}
        if 'priors' in self.main_config:
            self.priors = self._init_priors(self.main_config['priors'])
            for param in self.priors:
                not_sampled = param not in self.sample_params['limits']
                if self.mc_config is not None:
                    not_sampled &= (param
                                    not in self.mc_config['sample']['limits'])
                if not_sampled:
                    raise ValueError('Prior specified for a parameter that '
                                     f'is not sampled: {param}')

        # Global covariance (vega_interface.py:179-184)
        self._use_global_cov = global_cov_file is not None
        self.global_cov = None
        self._joint_data = (None, None)
        if self._use_global_cov:
            self.read_global_cov(global_cov_file,
                                 control.getfloat('cov_scale', None)
                                 if control else None)

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
        # data-dependent caches, keyed on the data vectors' ids as well;
        # each entry holds the vectors, so no id is reused while cached
        self._collapse_data_cache = {}
        self._grid_cache = {}
        self._device_memo = {}
        self._data_vec_cache = (None, None, None)
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
        self.analysis = Analysis(self.chi2, self.sample_params,
                                 self.main_config, self.corr_items,
                                 self.data, self.mc_config, self.global_cov,
                                 grad_func=self.chi2_gradient,
                                 hess_func=self.chi2_hessian, vega=self)
        # the samplers' derived columns (vega_interface.py:201-204)
        self.corr_num_marg_modes = {name: self.data[name].num_marg_modes
                                    for name in self.corr_items}
        self.output = Output(self.main_config['output'], self.data,
                             self.corr_items, self.analysis)

        # Sampler flags (vega_interface.py:206-220); the names are
        # vega_tpu's, so one ini serves both packages
        self.run_sampler = False
        self.sampler = None
        if 'control' in self.main_config:
            self.run_sampler = self.main_config['control'].getboolean(
                'run_sampler', False)
            self.sampler = self.main_config['control'].get('sampler', None)
            if self.run_sampler:
                if self.sampler not in ['Polychord', 'PocoMC', 'NestedJax',
                                        'HMC']:
                    raise ValueError('Sampler not recognized. Use Polychord, '
                                     'PocoMC, NestedJax or HMC.')
                if self.sampler not in self.main_config:
                    raise RuntimeError(
                        'run_sampler set, but no sampler config found')

        self.monte_carlo = False
        self._plots = None

    @property
    def plots(self):
        """The plots of the data (plots.plot.VegaPlots), built at first
        use: matplotlib is imported here and nowhere else of the
        interface (vega_interface.py:227-230 builds them at
        construction)."""
        if self._plots is None:
            from .plots.plot import VegaPlots
            self._plots = VegaPlots(vega_data=self.data)
        return self._plots

    def _build_models(self):
        """One Model per correlation, under the current fiducial."""
        self.models = {name: Model(item, self.fiducial, self.scale_params,
                                   self.data[name], device=self.device,
                                   dtype=self.dtype)
                       for name, item in self.corr_items.items()}

    def set_fiducial_pk(self, pk_full, pk_smooth):
        """Install the fiducial linear spectra (host arrays)."""
        self.fiducial['pk_full'] = np.asarray(pk_full, dtype=np.float64)
        self.fiducial['pk_smooth'] = np.asarray(pk_smooth, dtype=np.float64)
        self._pk_full = to_tensor(pk_full, self.device, self.dtype)
        self._pk_smooth = to_tensor(pk_smooth, self.device, self.dtype)

    def set_chi2_constants(self):
        """Copy the chi^2-side host arrays (masked inverse covariance,
        model mask) to the device: per correlation, or under a global
        covariance once for the concatenated correlations (key
        '_global', vega_interface.py:271-277). The data vectors change
        with Monte-Carlo mocks: `_device_data_vecs` copies those. Under
        marginalize-in-fit also the templates (`_set_marg_constants`)."""
        if self.marginalize_in_fit:
            self._set_marg_constants()
        if self._use_global_cov:
            self._chi2_data = {'_global': {
                'inv_cov': to_tensor(self.masked_global_invcov,
                                     self.device, self.dtype),
                'model_index': torch.as_tensor(
                    np.flatnonzero(self.full_model_mask), dtype=torch.int64,
                    device=self.device)}}
            return
        self._chi2_data = {}
        for name, d in self.data.items():
            self._chi2_data[name] = {
                'inv_cov': to_tensor(d.inv_masked_cov, self.device,
                                     self.dtype),
                'model_index': torch.as_tensor(
                    np.flatnonzero(d.model_mask), dtype=torch.int64,
                    device=self.device),
            }

    def _set_marg_constants(self):
        """The templates T (n_model, n_t) and the coefficient matrix D2C
        (n_t, n_masked) of each marginalized correlation on the device,
        for marginalize-in-fit (vega_interface.py:269-285); per
        correlation, also beside a global covariance."""
        self._marg_data = {
            name: {'templates': to_tensor(d.marg_templates, self.device,
                                          self.dtype),
                   'diff2coeff': to_tensor(d.marg_diff2coeff_matrix,
                                           self.device, self.dtype),
                   'model_index': torch.as_tensor(
                       np.flatnonzero(d.model_mask), dtype=torch.int64,
                       device=self.device)}
            for name, d in self.data.items()
            if d.marg_diff2coeff_matrix is not None}

    def _fit_marg_templates(self, name, model, data_vecs):
        """marginalize-in-fit: the model (B, n_model) plus T . coeff, with
        coeff = D2C (d - m[mask]) per row (vega_interface.py:441-447,
        532-544); the model as given for a correlation without
        templates. Two GEMMs, which vega_tpu runs outside any Pallas
        kernel."""
        marg = self._marg_data.get(name)
        if marg is None:
            return model
        diff = data_vecs[name] - model[:, marg['model_index']]
        coeff = diff @ marg['diff2coeff'].T
        return model + coeff @ marg['templates'].T

    def _current_data_vecs(self):
        """The masked data vector each chi^2 compares with, host numpy:
        the data, or the Monte-Carlo mock (vega_interface.py:977-988);
        under a global covariance one joint vector, key '_global'."""
        if self._use_global_cov:
            if self.monte_carlo:
                return {'_global': self.analysis.current_mc_mock}
            return {'_global': self._joint_data_vec()}
        if self.monte_carlo:
            return {name: self.data[name].masked_mc_mock
                    for name in self.corr_items}
        return {name: self.data[name].masked_data_vec
                for name in self.corr_items}

    def _joint_data_vec(self):
        """The masked data vectors concatenated, made again only when one
        of them is replaced (so its id versions the data, `_data_key`)."""
        parts = tuple(self.data[name].masked_data_vec
                      for name in self.corr_items)
        held, joint = self._joint_data
        if held is None or any(a is not b for a, b in zip(held, parts)):
            joint = np.concatenate(parts)
            self._joint_data = (parts, joint)
        return joint

    def _data_key(self):
        """(key, vectors): the current data vectors' version (Monte-Carlo
        mode and ids, vega_interface.py:642-644,786) and the vectors
        themselves, which a cache entry keeps so their ids stay unique."""
        vecs = tuple(self._current_data_vecs().values())
        return (self.monte_carlo,) + tuple(id(v) for v in vecs), vecs

    def _device_data_vecs(self):
        """Device copies of `_current_data_vecs`, made again when the
        vectors change (vega_interface.py:990-999)."""
        key, _ = self._data_key()
        if self._data_vec_cache[0] != key:
            vecs = self._current_data_vecs()
            self._data_vec_cache = (key, {
                name: to_tensor(v, self.device, self.dtype)
                for name, v in vecs.items()},
                tuple(vecs.values()))
        return self._data_vec_cache[1]

    def _current_cov_scales(self):
        """Each correlation's chi^2 scale: 1 / the Monte-Carlo covariance
        scale in MC mode, else 1 (vega_interface.py:1001-1010)."""
        scales = {}
        for name in self.corr_items:
            corr_data = self.data[name]
            if (self.monte_carlo
                    and corr_data.scaled_inv_masked_cov is not None):
                scales[name] = 1.0 / corr_data._scale
            else:
                scales[name] = 1.0
        return scales

    # ------------------------------------------------------------------
    # Batched model + chi^2
    # ------------------------------------------------------------------
    def _batch_params(self, params):
        """Local parameter dict: the stored floats, overridden by `params`
        as (B,) tensors on the device in its dtype. Returns (dict, B)."""
        local = copy.copy(self.params)
        for name, value in (params or {}).items():
            local[name] = torch.as_tensor(value, dtype=self.dtype,
                                          device=self.device).reshape(-1)
        sizes = {local[name].shape[0] for name in (params or {})}
        n_b = max(sizes, default=1)
        if not sizes <= {1, n_b}:
            raise ValueError(f'parameter batches of different lengths: '
                             f'{sorted(sizes)}')
        return local, n_b

    def _model_graph(self, local_params, n_b, use_kernel=True, save=False):
        """(model_cf {name: (B, M)}, bad (B,)) for every correlation,
        dense; `save` keeps the components (Model.compute)."""
        model_cf = {}
        bad = torch.zeros(n_b, dtype=torch.bool, device=self.device)
        for name in self.corr_items:
            cf, cf_bad = self.models[name].compute(
                local_params, self._pk_full, self._pk_smooth,
                use_kernel=use_kernel, save=save)
            model_cf[name] = cf.expand(n_b, -1)
            bad = bad | cf_bad
        return model_cf, bad

    def _chi2_rows(self, local_params, n_b, use_kernel=True, names=(),
                   collapsed=None, data_vecs=None, cov_scales=None):
        """chi^2 of B rows (vega_interface.py:374-530): correlations in
        `collapsed` from their quadratic form in the coefficients, every
        other one densely at the true values, each times its scale.

        data_vecs: {name: (n_masked,) or (B, n_masked) device tensor}, a
        data vector per row (Monte-Carlo mock fits); default the current
        ones (`_device_data_vecs`). A collapse with data terms (y, s) or a
        grid payload bakes the current data in and takes none.
        cov_scales: {name: float}, default `_current_cov_scales`."""
        if self._chi2_data is None:
            self.set_chi2_constants()
        collapsed = self._device_collapsed(collapsed or {})
        spec = collapsed.get('__grid__')
        if data_vecs is None:
            data_vecs = self._device_data_vecs()
        elif spec is not None or any('y' in t for t in collapsed.values()):
            raise ValueError('a collapse with the data terms baked in cannot '
                             'serve per-row data vectors')
        if cov_scales is None:
            cov_scales = self._current_cov_scales()
        sampling = Sampling(frozenset(names)) if self._factored and names \
            else None
        coeff_params = local_params
        if spec is not None:
            tvecs, excess = gridcollapse.grid_tvecs(spec, local_params, n_b)
            # the coefficient program at the grid reference values
            coeff_params = dict(local_params)
            coeff_params.update(zip(spec.names, spec.ref))
        chi2 = torch.zeros(n_b, dtype=self.dtype, device=self.device)
        bad = torch.zeros(n_b, dtype=torch.bool, device=self.device)
        if self._use_global_cov:
            # the joint quadratic form over the concatenated masked model
            # (vega_interface.py:449-455)
            models = []
            for name in self.corr_items:
                cf, cf_bad = self.models[name].compute(
                    local_params, self._pk_full, self._pk_smooth,
                    use_kernel=use_kernel, sampling=sampling)
                model = densify(cf).expand(n_b, -1)
                if self.marginalize_in_fit:
                    # per-correlation data vectors, which a joint
                    # covariance does not keep: vega_tpu's KeyError
                    model = self._fit_marg_templates(name, model, data_vecs)
                models.append(model)
                bad = bad | cf_bad
            joint = self._chi2_data['_global']
            diff = (data_vecs['_global']
                    - torch.cat(models, dim=-1)[:, joint['model_index']])
            chi2 = quadratic_rows(diff, joint['inv_cov'])
        else:
            for name in self.corr_items:
                arrays = self._chi2_data[name]
                if name in collapsed:
                    tensors = collapsed[name]
                    coeffs = self.models[name].coefficients(coeff_params,
                                                            n_b)
                    if coeffs.shape[-1] != tensors['cref'].shape[0]:
                        raise AssertionError(
                            'collapsed tensors do not match the factored '
                            f'term structure of {name}')
                    if spec is not None:
                        corr_chi2 = gridcollapse.grid_corr_chi2(
                            tensors, tvecs, coeffs)
                    else:
                        # centered quadratic form (vega_interface.py:
                        # 491-511): r'Ci r - 2 dc.(W r) + dc.(A dc) with
                        # r = d - m0, the data terms (y = W r, s = r'Ci r)
                        # taken on the host when the collapse has them
                        dc = coeffs - tensors['cref']
                        quad = torch.sum(dc * (dc @ tensors['A'].T), dim=-1)
                        if 'y' in tensors:
                            corr_chi2 = (tensors['s']
                                         - 2.0 * (dc @ tensors['y']) + quad)
                        else:
                            r = data_vecs[name] - tensors['m0']
                            corr_chi2 = (
                                quadratic_rows(r, arrays['inv_cov'])
                                - 2.0 * torch.sum(dc * (r @ tensors['W'].T),
                                                  dim=-1)
                                + quad)
                else:
                    cf, cf_bad = self.models[name].compute(
                        local_params, self._pk_full, self._pk_smooth,
                        use_kernel=use_kernel, sampling=sampling)
                    model = densify(cf).expand(n_b, -1)
                    if self.marginalize_in_fit:
                        model = self._fit_marg_templates(name, model,
                                                         data_vecs)
                    diff = data_vecs[name] - model[:, arrays['model_index']]
                    corr_chi2 = quadratic_rows(diff, arrays['inv_cov'])
                    bad = bad | cf_bad
                # a scale of 1 multiplies nothing (exact either way)
                scale = cov_scales[name]
                chi2 = chi2 + (corr_chi2 if scale == 1.0
                               else scale * corr_chi2)
        chi2 = chi2 + self._prior_chi2(local_params)
        if spec is not None:
            # smooth wall outside the node domain (GRID_WALL_CHI2)
            chi2 = chi2 + gridcollapse.GRID_WALL_CHI2 * excess
        return torch.where(bad, penalty_chi2(self.dtype), chi2)

    def compute_prior_chi2(self, params=None):
        """chi^2 of the Gaussian priors at one point: the stored values
        overridden by `params` (vega_interface.py:1350-1352)."""
        local, _ = self._batch_params(params)
        return float(self._prior_chi2(local))

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
        """chi^2 for a batch: {name: (B,) values} -> (B,) tensor of the
        interface's dtype on its device, dispatched by the names as
        vega_tpu does (`get_collapsed`). Runs in chunks of `chunk_rows`
        rows (default CHUNK_ROWS, or COLLAPSED_CHUNK_ROWS when every
        correlation is served by a collapse).

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
        out = torch.empty(n_b, dtype=self.dtype, device=self.device)
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

    def chi2(self, params=None, return_marg_coeff=False):
        """Full chi^2 at one parameter point (reference:
        vega_interface.py:1178-1226): a batch of one. return_marg_coeff
        also gives {name: the best-fit template coefficients} of the
        model at the point (`compute_marg_coeff`), which under
        marginalize-in-fit are the ones the chi^2 fitted."""
        chi2 = float(self.chi2_batch(params or {})[0])
        if return_marg_coeff:
            return chi2, self.compute_marg_coeff(
                self.compute_model(params, run_init=False))
        return chi2

    def log_lik(self, params=None, return_marg_coeff=False):
        """Full log-likelihood (reference: vega_interface.py:1270-1292): a
        batch of one. return_marg_coeff also gives the coefficients of
        every marginalized correlation in one array, correlations in
        sorted order (None without any)."""
        if not return_marg_coeff:
            return float(self.log_lik_batch(params or {})[0])
        chi2, marg_coeff = self.chi2(params, return_marg_coeff=True)
        log_lik = self._log_norm() - 0.5 * chi2
        for prior in self.priors.values():
            log_lik += self._gaussian_lik_prior(prior[1])
        marg_list = None
        if marg_coeff:
            corr_names = sorted(n for n in self.corr_items if n in marg_coeff)
            marg_list = (np.hstack([marg_coeff[c] for c in corr_names])
                         if corr_names else np.array([]))
        return log_lik, marg_list

    def compute_marg_coeff(self, model_cf):
        """{name: D2C (d - m[mask])} for each marginalized correlation of
        the host models `model_cf`, against the Monte-Carlo mock in MC
        mode (vega_interface.py:1354-1368)."""
        coeffs = {}
        for name in self.corr_items:
            corr_data = self.data[name]
            if corr_data.marg_diff2coeff_matrix is None:
                continue
            if self.monte_carlo:
                diff = corr_data.masked_mc_mock \
                    - model_cf[name][corr_data.model_mask]
            else:
                diff = corr_data.masked_data_vec \
                    - model_cf[name][corr_data.model_mask]
            coeffs[name] = corr_data.marg_diff2coeff_matrix.dot(diff)
        return coeffs

    def _log_norm(self):
        """(vega_interface.py:1294-1306)"""
        log_norm = 0.
        for name in self.corr_items:
            log_norm -= 0.5 * self.data[name].data_size * np.log(2 * np.pi)
            if self._use_global_cov:
                continue
            if (self.monte_carlo
                    and self.data[name].scaled_log_cov_det is not None):
                log_norm -= 0.5 * self.data[name].scaled_log_cov_det
            else:
                log_norm -= 0.5 * self.data[name].log_cov_det
        if self._use_global_cov:
            log_norm -= 0.5 * self.masked_global_log_cov_det
        return log_norm

    # ------------------------------------------------------------------
    # Derivatives (vega_interface.py:883-912,949-975)
    # ------------------------------------------------------------------
    def chi2_value_and_gradient(self, params, use_kernel=True):
        """(chi^2, {name: d chi^2 / d name}) over every key of `params`,
        exact (torch autograd, reverse mode): the minimizer's hot path.
        Dispatched by the names of `params` as chi2_batch dispatches
        them, each a 0-d leaf on the device in its dtype; `_chi2_rows` on
        a batch of one. use_kernel=False takes the plain PyTorch combine
        on a CUDA device (for comparing it with the kernels)."""
        names = frozenset(params)
        collapsed = self.get_collapsed(names)
        with torch.enable_grad():
            leaves = {name: torch.tensor(float(value), dtype=self.dtype,
                                         device=self.device,
                                         requires_grad=True)
                      for name, value in params.items()}
            local, _ = self._batch_params(leaves)
            chi2 = self._chi2_rows(local, 1, use_kernel, names, collapsed)[0]
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
        other names of `params` held fixed: `chi2_batch_derivatives` on a
        batch of one."""
        free_names = list(free_names)
        hess = self.chi2_batch_derivatives(
            free_names, [[float(params[n]) for n in free_names]],
            fixed={n: float(v) for n, v in params.items()
                   if n not in free_names},
            use_kernel=use_kernel)[2][0].tolist()
        return {n1: {n2: hess[i][j] for j, n2 in enumerate(free_names)}
                for i, n1 in enumerate(free_names)}

    def chi2_batch_derivatives(self, free_names, values, fixed=None,
                               data_vecs=None, cov_scales=None,
                               use_kernel=True, hessian=True):
        """Exact chi^2 (B,), gradient (B, n) and Hessian (B, n, n) over
        the n `free_names` for B independent rows, as tensors of the
        interface's dtype on the device: the batched Newton's derivatives
        (what vega_tpu takes with jax.grad / jax.hessian under jax.vmap,
        parallel/batch.py:313-314).

        values: (B, n) free values; fixed: {name: float or (B,) values}
        for other parameters (a scan's fixed grid values); the rest keep
        their stored values. Dispatched by the names as chi2_batch
        dispatches them. data_vecs: {name: (B, n_masked)} a data vector
        per row (Monte-Carlo mocks): the call then takes the collapse
        without data terms (`get_collapsed(..., with_data_terms=False)`,
        {} for a grid payload: the dense path). cov_scales as in
        `_chi2_rows`. use_kernel=False takes the plain combine on a CUDA
        device. hessian=False stops after the gradient (one backward pass
        that builds no graph of its own: HMC's leapfrog steps) and gives
        None for the Hessian.

        Each free parameter is a (B,) leaf; the rows are independent, so
        the gradient of chi^2.sum() is each row's gradient, and one more
        backward pass per free name gives each row's Hessian row (reverse
        over reverse; through the combine that is the Functions' double
        backward, ops/spline_combine.py)."""
        free_names = list(free_names)
        fixed = dict(fixed or {})
        names = frozenset(free_names) | frozenset(fixed)
        collapsed = self.get_collapsed(names,
                                       with_data_terms=data_vecs is None)
        values = torch.as_tensor(values, dtype=self.dtype,
                                 device=self.device)
        with torch.enable_grad():
            leaves = [values[:, i].detach().clone().requires_grad_(True)
                      for i in range(len(free_names))]
            local, n_b = self._batch_params(
                {**fixed, **dict(zip(free_names, leaves))})
            n_b = max(n_b, values.shape[0])
            chi2 = self._chi2_rows(local, n_b, use_kernel, names, collapsed,
                                   data_vecs, cov_scales)
            n_free = len(leaves)
            if not hessian:
                if not n_free:
                    return chi2.detach(), chi2.new_zeros((n_b, 0)), None
                grads = torch.autograd.grad(chi2.sum(), leaves,
                                            materialize_grads=True)
                return chi2.detach(), torch.stack(grads, dim=-1), None
            hess = torch.zeros((n_b, n_free, n_free), dtype=self.dtype,
                               device=self.device)
            if not n_free:
                return chi2.detach(), hess.new_zeros((n_b, 0)), hess
            grads = torch.autograd.grad(chi2.sum(), leaves, create_graph=True,
                                        materialize_grads=True)
            for i, grad in enumerate(grads):
                if grad.requires_grad:      # else chi^2 is linear in it
                    row = torch.autograd.grad(grad.sum(), leaves,
                                              retain_graph=True,
                                              materialize_grads=True)
                    hess[:, i] = torch.stack(row, dim=-1)
        return chi2.detach(), torch.stack(grads, dim=-1).detach(), hess

    # ------------------------------------------------------------------
    # The fit (vega_interface.py:1443-1506)
    # ------------------------------------------------------------------
    def minimize(self):
        """Minimize chi^2 over the sampled parameters, then the best-fit
        model, per-correlation chi^2, reduced chi^2 and PTE
        (vega_interface.py:1443-1502): against the Monte-Carlo mock and
        its scaled covariance in MC mode; with marginalization each
        correlation's effective size, its best-fit template coefficients
        and the templates added to its best-fit model
        (vega_interface.py:1476-1490)."""
        if self.minimizer is None:
            print('No sampled parameters. Skipping minimization.')
            return

        self.minimizer.minimize()

        self.bestfit_model = self.compute_model(self.minimizer.values,
                                                run_init=False)
        self.total_data_size = 0
        self.bestfit_corr_stats = {}
        num_pars = len(self.sample_params['limits'])

        print('\n----------------------------------------------------')
        for name in self.corr_items:
            corr_data = self.data[name]
            data_size = corr_data.effective_data_size
            self.total_data_size += data_size
            diff = None
            if self.monte_carlo and self._use_global_cov:
                # no per-correlation mock (vega_interface.py:1464-1466)
                chisq = 0
            elif self.monte_carlo:
                diff = corr_data.masked_mc_mock \
                    - self.bestfit_model[name][corr_data.model_mask]
                chisq = diff.T.dot(corr_data.scaled_inv_masked_cov.dot(diff))
            else:
                diff = corr_data.masked_data_vec \
                    - self.bestfit_model[name][corr_data.model_mask]
                chisq = diff.T.dot(corr_data.inv_masked_cov.dot(diff))
            bestfit_marg_coeff = None
            if (corr_data.marg_diff2coeff_matrix is not None
                    and diff is not None):
                bestfit_marg_coeff = corr_data.marg_diff2coeff_matrix.dot(diff)
                self.bestfit_model[name] = self.bestfit_model[name] + \
                    corr_data.marg_templates.dot(bestfit_marg_coeff)
            reduced_chisq = chisq / (data_size - num_pars)
            p_value = 1 - scipy.stats.chi2.cdf(chisq, data_size - num_pars)
            print(f'{name} chi^2/(ndata-nparam): {chisq:.1f}/({data_size}'
                  f'-{num_pars}) = {reduced_chisq:.3f}, PTE={p_value:.2f}')
            print('----------------------------------------------------')
            self.bestfit_corr_stats[name] = {
                'masked_size': data_size, 'chisq': chisq,
                'reduced_chisq': reduced_chisq, 'p_value': p_value,
                'bestfit_marg_coeff': bestfit_marg_coeff,
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

    def set_fast_metals(self):
        """Turn fast metals on in every model's metals
        (vega_interface.py:1431-1441): the growth rate of the unrolled
        pairs stays the fiducial one and their bias product is taken
        outside their spectra."""
        print('Warning! Activating fast metals for minimizing/sampling.')
        for name in self.corr_items:
            metals = self.models[name].metals
            if metals is not None:
                metals.fast_metals = True

    # ------------------------------------------------------------------
    # Fisher sensitivity (vega_interface.py:1508-1688)
    # ------------------------------------------------------------------
    def _nominal(self, nominal):
        """{name: (value, error)}: `nominal`, or the best fit's."""
        if nominal is None:
            if self.bestfit is None or not self.bestfit.run_flag:
                raise RuntimeError(
                    'No nominal parameter values provided or saved')
            nominal = {name: (self.bestfit.values[name],
                              self.bestfit.errors[name])
                       for name in self.bestfit.values}
        return nominal

    def _sensitivity_components(self, model, pars):
        """vega_tpu's component graph of one model
        (vega_interface.py:1537-1576): peak and smooth (their spectra as
        `Model.compute` builds them: the same factors as vega_tpu's
        `_shared_factor` there, multiplied in `compute_peak_smooth`'s
        order), the metals on the full spectrum added to the smooth
        whatever no-metal-decomp says,
        through the distortion matrix and without it; no broadband and
        no instrumental systematics. (B', 2 distorted / raw, 2 peak /
        smooth, n) for (B,) parameters."""
        pars = dict(pars)
        pars['peak'] = True
        pk_peak_lin = self._pk_full - self._pk_smooth
        pk_peak, pk_smooth, _ = model.Pk_core.compute_peak_smooth(
            pars, pk_peak_lin, self._pk_smooth)
        xi_peak, _ = model.Xi_core.compute(pk_peak, model.PktoXi, pars,
                                           pk_lin=pk_peak_lin)
        pars['peak'] = False
        xi_smooth, _ = model.Xi_core.compute(pk_smooth, model.PktoXi, pars,
                                             pk_lin=self._pk_smooth)
        if model.metals is not None:
            xi_metals, _ = model.metals.compute(pars, self._pk_full)
            xi_smooth = xi_smooth + densify(xi_metals)
        xi_peak, xi_smooth = torch.broadcast_tensors(xi_peak, xi_smooth)
        raw = torch.stack([xi_peak, xi_smooth], dim=-2)
        distorted = (raw if model._dist_mat is None
                     else raw @ model._dist_mat.T)
        return torch.stack([distorted, raw], dim=-3)

    def _component_jacobian(self, name, values, free):
        """Exact partials of `_sensitivity_components` of one correlation
        at `values` ({name: float}) in the P names `free`: (P, 2, 2, n).

        Forward-mode columns without a forward mode: every row r of a
        batch of P equal rows carries its own leaf of each name, so with
        u the components' cotangent, g_q = d(sum u . f)/d theta_q holds
        row r's u_r . df_r/dtheta_q at r, and the gradient of
        sum_r g_r[r] in u is row r's column df_r/dtheta_r. One forward,
        one backward with its graph kept and one backward of that give
        all P columns (through the combine its Functions' forward,
        transpose and derivative kernels, ops/spline_combine.py)."""
        n_free = len(free)
        with torch.enable_grad():
            leaves = [torch.full((n_free,), float(values[p]), dtype=self.dtype,
                                 device=self.device, requires_grad=True)
                      for p in free]
            local = dict(values)
            local.update(zip(free, leaves))
            comps = self._sensitivity_components(self.models[name], local)
            shape = (n_free,) + comps.shape[1:]
            if not comps.requires_grad:
                return comps.new_zeros(shape)
            probe = torch.zeros(shape, dtype=self.dtype, device=self.device,
                                requires_grad=True)
            grads = torch.autograd.grad((probe * comps).sum(), leaves,
                                        create_graph=True,
                                        materialize_grads=True)
            diagonal = sum(g[r] for r, g in enumerate(grads))
            if not diagonal.requires_grad:
                return comps.new_zeros(shape)
            (jac,) = torch.autograd.grad(diagonal, probe,
                                         materialize_grads=True)
        return jac

    def compute_sensitivity_exact(self, nominal=None, verbose=True):
        """Model sensitivity from exact partials of vega_tpu's component
        graph (vega_interface.py:1511-1595): `sensitivity['partials']
        [corr][name]` is (2 distorted / raw, 2 peak / smooth, n_bins),
        the peak's times the stored bao_amp, and `['fisher']` as
        `compute_sensitivity` gives it. nominal: {name: (value, error)},
        default the best fit."""
        nominal = self._nominal(nominal)
        values = copy.deepcopy(self.params)
        for pname, (pvalue, _) in nominal.items():
            values[pname] = pvalue
        free = list(nominal)
        bao_amp = self.params['bao_amp']
        self.sensitivity = dict(nominal=copy.deepcopy(nominal),
                                partials={}, fisher={})
        for name in self.corr_items:
            jac = self._component_jacobian(name, values,
                                           free).cpu().numpy()
            jac[:, :, 0, :] *= bao_amp
            self.sensitivity['partials'][name] = {
                pname: jac[i] for i, pname in enumerate(free)}
            self.sensitivity['fisher'][name] = {}
        self._fill_fisher(nominal, verbose)

    def _fill_fisher(self, nominal, verbose=True):
        """Fisher information per bin of each pair of names, distorted
        and raw: the summed partials' masked product through the inverse
        covariance, NaN outside the mask (vega_interface.py:1597-1617)."""
        if verbose:
            print('Computing Fisher information for each pair of parameters.')
        for pindex1, pname1 in enumerate(nominal):
            for pindex2, pname2 in enumerate(nominal):
                if pindex1 > pindex2:
                    continue
                for n in self.corr_items:
                    rp = self.corr_items[n].model_coordinates.rp_grid
                    fisher = np.zeros((2, len(rp)))
                    mask = self.data[n].data_mask
                    for idistort in range(2):
                        partial1 = self.sensitivity['partials'][n][pname1][
                            idistort].sum(axis=0)
                        partial2 = self.sensitivity['partials'][n][pname2][
                            idistort].sum(axis=0)
                        masked_info = (partial1[mask] * self.data[
                            n].inv_masked_cov.dot(partial2[mask]))
                        fisher[idistort, mask] = masked_info
                        fisher[idistort, ~mask] = np.nan
                    self.sensitivity['fisher'][n][(pname1, pname2)] = fisher

    def compute_sensitivity(self, nominal=None, frac=0.1, verbose=True):
        """Model sensitivity and Fisher information per (rp, rt) bin by
        central differences (vega_interface.py:1619-1688): turns
        save-components on, then per name and sign rebuilds the models
        (`compute_model(run_init=True)`) and differences the saved
        components at value +/- frac x error. nominal: {name: (value,
        error)}, default the best fit."""
        nominal = self._nominal(nominal)
        params = copy.deepcopy(self.params)
        for pname, (pvalue, _) in nominal.items():
            params[pname] = pvalue

        self.sensitivity = dict(nominal=copy.deepcopy(nominal),
                                partials={}, fisher={})
        for name in self.corr_items:
            self.sensitivity['partials'][name] = {}
            self.sensitivity['fisher'][name] = {}

        self.fiducial['save-components'] = True
        bao_amp = self.params['bao_amp']
        for pindex, (pname, (pvalue, perror)) in enumerate(nominal.items()):
            if verbose:
                print(f'Calculating sensitivity for [{pindex}] {pname} at'
                      f' {pvalue:.4f} +/- {perror:.4f}')
            delta = frac * perror
            for sign in (+1, -1):
                params[pname] = pvalue + sign * delta
                cfs = self.compute_model(params, run_init=True)
                for n in cfs:
                    if pname not in self.sensitivity['partials'][n]:
                        rp = self.corr_items[n].model_coordinates.rp_grid
                        self.sensitivity['partials'][n][pname] = \
                            np.zeros((2, 2, len(rp)))
                    model = self.models[n]
                    part = self.sensitivity['partials'][n][pname]
                    part[0, 0] += sign * bao_amp * \
                        model.xi_distorted['peak']['core']
                    part[0, 1] += sign * model.xi_distorted['smooth']['core']
                    part[1, 0] += sign * bao_amp * model.xi['peak']['core']
                    part[1, 1] += sign * model.xi['smooth']['core']
            for n in self.corr_items:
                self.sensitivity['partials'][n][pname] /= 2 * delta
            params[pname] = pvalue
        self._fill_fisher(nominal, verbose)

    # ------------------------------------------------------------------
    # Monte Carlo (vega_interface.py:1373-1428)
    # ------------------------------------------------------------------
    def get_fiducial_for_monte_carlo(self, print_func=print):
        """The model the mocks are drawn around: at [mc parameters] over
        the best fit of a saved fit ([control] mc_start_from_fit, read
        with postprocess.FitResults) or else of [sample] (a fit runs first
        when anything is sampled), or read from the files [control]
        mc_fiducial_<name> names when use_measured_fiducial is set
        (vega_interface.py:1375-1403)."""
        mc_params = self.mc_config['params']
        control = self.main_config['control']
        mc_start_from_fit = control.get('mc_start_from_fit', None)
        if control.getboolean('use_full_pk_for_mc', False):
            raise not_ported('use_full_pk_for_mc (the model from a given '
                             'power spectrum, compute_direct)', 5)
        if mc_start_from_fit is not None:
            from .postprocess.fit_results import FitResults
            print_func(f'Reading input fit {mc_start_from_fit}')
            existing_fit = FitResults(utils.find_file(mc_start_from_fit))
            mc_params = existing_fit.params | mc_params
        elif self.sample_params['limits']:
            print_func('Running initial fit')
            self.minimize()
            mc_params = self.bestfit.values | mc_params

        if control.getboolean('use_measured_fiducial', False):
            fiducial_model = {}
            for name in self.corr_items:
                path = control.get(f'mc_fiducial_{name}')
                hdul = read_fits(utils.find_file(path))
                fiducial_model[name] = hdul[1]['DA']
            return fiducial_model
        return self.compute_model(mc_params, run_init=False)

    def initialize_monte_carlo(self, scale=None, print_func=print):
        """Draw one mock per correlation around the fiducial (seed
        [control] mc_seed, noiseless with forecast = True), fit the
        [monte carlo] parameters from now on, and switch the chi^2 to the
        mock. Returns the mocks."""
        fiducial_model = self.get_fiducial_for_monte_carlo(print_func)
        self.minimizer = Minimizer(
            self.chi2, self.mc_config['sample'],
            grad_func=self.chi2_gradient, hess_func=self.chi2_hessian,
            valgrad_func=self.chi2_value_and_gradient)
        control = self.main_config['control']
        seed = control.getint('mc_seed', 0)
        forecast = control.getboolean('forecast', False)
        if self._use_global_cov:
            # one mock of the joint data vector (vega_interface.py:
            # 1417-1421)
            if scale is None and 'global_cov_rescale' in control:
                scale = control.getfloat('global_cov_rescale')
            mocks = self.analysis.create_global_monte_carlo(
                fiducial_model, seed=seed, scale=scale, forecast=forecast)
        else:
            mocks = self.analysis.create_monte_carlo_sim(
                fiducial_model, seed=seed, scale=scale, forecast=forecast)
        self.monte_carlo = True
        return mocks

    @torch.no_grad()
    def compute_model(self, params=None, run_init=True, use_kernel=True,
                      marg_coeff=None):
        """Model correlations at one point as numpy arrays
        (vega_interface.py:1015-1099); raises VegaModelError where the
        chi^2 would take the penalty. run_init=True builds the models
        anew first, so that a changed fiducial (save-components) takes
        effect, and drops the collapses built from the old ones
        (vega_interface.py:1060-1071). With save-components each model
        keeps this evaluation's components. `marg_coeff` ({name:
        coefficients}) adds each marginalized correlation's templates
        times its coefficients (vega_interface.py:1093-1097)."""
        if run_init:
            self._build_models()
            self._collapsed_cache = {}
            self._collapse_data_cache = {}
            self._grid_cache = {}
            self._device_memo = {}
        local, _ = self._batch_params(params)
        model_cf, bad = self._model_graph(
            local, 1, use_kernel,
            save=self.fiducial.get('save-components', False))
        if bool(bad.any()):
            raise utils.VegaModelError(
                'Model evaluation failed (out-of-bounds interpolation)')
        model_cf = {name: cf[0].cpu().numpy()
                    for name, cf in model_cf.items()}
        if marg_coeff is not None:
            for name in self.data:
                if self.data[name].marg_templates is not None:
                    model_cf[name] = model_cf[name] + \
                        self.data[name].marg_templates.dot(marg_coeff[name])
        return model_cf

    # ------------------------------------------------------------------
    # Collapses (vega_interface.py:288-348,563-875)
    # ------------------------------------------------------------------
    def get_collapsed(self, sample_names, with_data_terms=True):
        """Collapse tensors for one sampled-parameter set, cached as host
        numpy (vega_interface.py:563-629): the grid payload when a grid
        parameter is sampled, else the nuisance-only collapse of every
        correlation whose model stays factored, else {} (dense path).
        with_data_terms=False skips the data-side (y, s) terms and gives
        {} for a grid payload, which bakes the data vector in. Under a
        global covariance or marginalize-in-fit always {}: every call is
        served densely, as vega_tpu serves it (vega_interface.py:
        576-579)."""
        key = frozenset(sample_names)
        if (not key or not self._factored or self._use_global_cov
                or self.marginalize_in_fit):
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
        model run on the device, returned as host numpy. {} under a
        global covariance or marginalize-in-fit (vega_interface.py:305)."""
        if self._use_global_cov or self.marginalize_in_fit:
            return {}
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
        """y = W r and s = r' Ci r with r = d - m0 against the current
        data vector, host f64, cached per data version
        (vega_interface.py:631-657)."""
        if not collapsed:
            return collapsed
        data_key, vecs = self._data_key()
        cache_key = (key, data_key)
        if cache_key not in self._collapse_data_cache:
            by_name = dict(zip(self.corr_items, vecs))
            merged = {}
            for name, tensors in collapsed.items():
                r = by_name[name] - tensors['m0']
                inv_cov = np.asarray(self.data[name].inv_masked_cov)
                merged[name] = dict(tensors, y=tensors['W'] @ r,
                                    s=float(r @ (inv_cov @ r)))
            self._collapse_data_cache[cache_key] = (vecs, merged)
        return self._collapse_data_cache[cache_key][1]

    def use_grid_payload(self, sample_names, payload):
        """Serve `sample_names` from a given grid payload (for example
        one built by vega_tpu and read with gridcollapse.load_payload)
        instead of sweeping: it takes the place of the in-memory entry
        for the current sampling limits and data vectors."""
        key = frozenset(sample_names)
        grid_names = self._grid_candidate_names(key)
        if tuple(payload['__grid__'].names) != grid_names:
            raise ValueError(f'the payload is over {payload["__grid__"]}, '
                             f'the names sample the grid {grid_names}')
        self._grid_cache[self._grid_cache_key(key)] = (
            self._data_key()[1], payload)

    def _grid_cache_key(self, key):
        """A grid payload depends on the sampled set, the sampling limits
        (through measure_dc_max; vega_tpu's key omits them) and the data
        vectors it bakes in (vega_interface.py:785-790)."""
        return key, self._limits_key(), self._data_key()[0]

    def _limits_dict(self):
        return {k: tuple(v) if isinstance(v, (tuple, list)) else v
                for k, v in self.sample_params['limits'].items()}

    def _limits_key(self):
        return tuple(sorted(self._limits_dict().items()))

    def _device_collapsed(self, collapsed):
        """Device copy of a host collapse or grid payload, with the
        per-evaluation arrays only, memoized by payload identity."""
        if not collapsed:
            return collapsed
        memo = self._device_memo.get(id(collapsed))
        if memo is None or memo[0] is not collapsed:
            if '__grid__' in collapsed:
                tensors = gridcollapse.device_payload(collapsed, self.device,
                                                      self.dtype)
            else:
                # with the host data terms (y, s), or without them (W, m0:
                # the data vector enters per evaluation, _chi2_rows)
                parts = (('y', 's') if 'y' in next(iter(collapsed.values()))
                         else ('W', 'm0'))
                tensors = {name: {
                    'A': to_tensor(t['A'], self.device, self.dtype),
                    'cref': to_tensor(t['c0'], self.device, self.dtype),
                    **{part: (float(t[part]) if part == 's'
                              else to_tensor(t[part], self.device,
                                             self.dtype))
                       for part in parts}}
                    for name, t in collapsed.items()}
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
        model's node-independent power spectra between chunks.

        In f32 the data terms come centred from the device instead of e:
        y(g) = W r and s(g) = r' Ci r with r = d - c0 V_m(g), the residual
        at the reference coefficients ({'A', 'y', 's'}). vega_tpu centres
        e on the host (s = d' Ci d - 2 e.c0 + c0' A c0), exact in f64, but
        in f32 its terms are ~1e5 each on synthetic-full where s is ~1e3:
        the residual keeps the cancellation out of f32."""
        if self._chi2_data is None:
            self.set_chi2_constants()
        data_vecs = self._device_data_vecs()
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
            payload[name] = {'A': w_mat @ v_mat.transpose(1, 2)}
            c0 = fxi.coeff_vector()
            if self.dtype == torch.float64:
                payload[name]['e'] = w_mat @ data_vecs[name]
            else:
                r = data_vecs[name] - c0 @ v_mat                  # (C, n_m)
                payload[name]['y'] = (w_mat @ r[..., None])[..., 0]
                payload[name]['s'] = quadratic_rows(r, arrays['inv_cov'])
            c0s[name] = c0
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
            if limits is None and self.mc_config is not None:
                limits = self.mc_config['sample']['limits'].get(name)
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
        """Grid-collapse payload for one sampled-parameter set
        (vega_interface.py:778-875), cached in memory (`_grid_cache_key`:
        a new data vector, e.g. a Monte-Carlo mock, builds a new payload)
        and, outside Monte-Carlo mode, on disk under its content
        fingerprint (gridcollapse.payload_cache_dir): a hit loads the
        payload and sweeps nothing, an unreadable entry is swept again
        with a warning, and a sweep checkpoints its node chunks into
        `<entry>.sweep`, removed once the payload is saved.
        `grid_stats['source']` says which: 'disk' or 'sweep'."""
        cache_key = self._grid_cache_key(key)
        if cache_key in self._grid_cache:
            return self._grid_cache[cache_key][1]
        vecs = self._data_key()[1]

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
            self._grid_cache[cache_key] = (vecs, {})
            return {}
        mode_budget = self._control_get('grid-mode-budget')
        if mode_budget is None:
            mode_budget = os.environ.get('VEGA_TPU_GRID_MODE_BUDGET', 2e-4)
        mode_budget = float(mode_budget)
        svd_tol = float(os.environ.get('VEGA_TPU_GRID_SVD_TOL', 1e-12))
        t0 = time.perf_counter()
        if self._chi2_data is None:     # host inverse covariances
            self.set_chi2_constants()
        stats = {'constants_s': time.perf_counter() - t0}

        disk_path = None
        cache_dir = None if self.monte_carlo else \
            gridcollapse.payload_cache_dir()
        if cache_dir is not None:
            t0 = time.perf_counter()
            limits = self._limits_dict()
            extra = (None if limits == self._config_limits
                     else repr(sorted(limits.items())))
            fingerprint = gridcollapse.payload_fingerprint(
                self, sorted(key), spec, mode_budget, svd_tol,
                components=components, extra=extra)
            os.makedirs(cache_dir, exist_ok=True)
            disk_path = os.path.join(cache_dir, f'grid_{fingerprint}.npz')
            stats.update(cache_path=disk_path,
                         fingerprint_s=time.perf_counter() - t0)
            if os.path.exists(disk_path):
                t0 = time.perf_counter()
                try:
                    payload = gridcollapse.load_payload(disk_path)
                except Exception as exc:    # an unreadable entry
                    print(f'WARNING: ignoring unreadable grid-payload '
                          f'cache entry {disk_path} ({exc})')
                else:
                    stats.update(source='disk',
                                 load_s=time.perf_counter() - t0)
                    return self._keep_grid_payload(cache_key, vecs, payload,
                                                   spec, stats)
        payload = gridcollapse.build_grid_payload(
            self, sorted(key), grid_names, spec, svd_tol=svd_tol,
            mode_budget=mode_budget, components=components, stats=stats,
            checkpoint_dir=None if disk_path is None else disk_path + '.sweep')
        stats['source'] = 'sweep'
        if len(payload) <= 1:       # only '__grid__': nothing factored
            payload = {}
        elif disk_path is not None:
            gridcollapse.save_payload(disk_path, payload)
        if disk_path is not None:
            shutil.rmtree(disk_path + '.sweep', ignore_errors=True)
        return self._keep_grid_payload(cache_key, vecs, payload, spec, stats)

    def _keep_grid_payload(self, cache_key, vecs, payload, spec, stats):
        """Check a swept or loaded payload's coefficient vectors against
        the coefficient program, record `stats` and cache the payload in
        memory."""
        self._check_coefficient_program(
            {name: p['cref'] for name, p in payload.items()
             if name != '__grid__'}, zip(spec.names, spec.ref))
        self.grid_stats = stats
        self._grid_cache[cache_key] = (vecs, payload)
        return payload

    # ------------------------------------------------------------------
    # Global covariance (vega_interface.py:1828-1872)
    # ------------------------------------------------------------------
    def read_global_cov(self, global_cov_file, scale=None):
        """Read the joint covariance of the concatenated correlations
        (FITS column COV), times `scale` ([control] cov_scale), and keep
        its masked inverse and log-determinant on the host. With
        low_mem_mode the full matrix is dropped once they are taken."""
        print(f'INFO: Reading global covariance from {global_cov_file}')
        hdul = read_fits(utils.find_file(global_cov_file))
        self.global_cov = hdul[1]['COV'].astype(float)
        if scale is not None:
            print('Rescaling covariance by a factor of: ', scale)
            self.global_cov *= scale
        self._use_global_cov = True

        self.full_data_mask = np.concatenate(
            [self.data[name].data_mask for name in self.corr_items])
        self.full_model_mask = np.concatenate(
            [self.data[name].model_mask for name in self.corr_items])

        # each marginalized correlation's covariance update on its block
        # (vega_interface.py:1844-1857)
        if any(item.marginalize_small_scales
               for item in self.corr_items.values()):
            print('Updating global covariance with marginalization templates.')
            j = 0
            for name in self.corr_items:
                data = self.data[name]
                ndata = data.full_data_size
                wd = data.data_mask
                if self.corr_items[name].marginalize_small_scales:
                    block = self.global_cov[j:j + ndata, j:j + ndata]
                    if data.cov_marg_update is not None:
                        block[np.ix_(wd, wd)] += data.cov_marg_update
                    if self.low_mem_mode:
                        del data.cov_marg_update
                j += ndata

        if self.low_mem_mode:
            masked_cov = self.global_cov[np.ix_(self.full_data_mask,
                                                self.full_data_mask)]
            self.global_cov = None
            self.masked_global_log_cov_det = np.linalg.slogdet(masked_cov)[1]
            self.masked_global_invcov = np.linalg.inv(masked_cov)
        else:
            self.masked_global_invcov = utils.compute_masked_invcov(
                self.global_cov, self.full_data_mask)
            self.masked_global_log_cov_det = utils.compute_log_cov_det(
                self.global_cov, self.full_data_mask)

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
