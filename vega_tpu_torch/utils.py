"""Shared utilities: file resolution, bias/beta algebra, covariance helpers
and the batch-axis helper every model module uses.

Counterpart of vega_tpu/utils.py. The host helpers are copies (numpy
only, pinned to the JAX package by tests/test_torch_host.py); data files
(`models/`, `parameters/`) are read from the JAX package's directories by
filesystem path, never through `import vega_tpu`, which imports JAX.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX_PACKAGE_DIR = REPO_ROOT / 'vega_tpu'

# parameter-level blinding (vega_tpu/utils.py:18-25): names a blinded fit
# must keep fixed, and the blinded names with the tracers they blind
BLIND_FIXED_PARS = [
    'ap_full', 'at_full', 'aiso_full', 'epsilon_full', 'phi_full',
]

VEGA_BLINDED_PARS = {
    'phi_smooth': ['all'],
    'growth_rate': ['all'],
}


class VegaModelError(Exception):
    """Model-domain failure (reference: utils.py:444-453). Per-evaluation
    failures become the chi^2 = 1e100 penalty instead."""


class VegaBoundsError(VegaModelError):
    """A value outside the range a host interpolation covers
    (vega_tpu/utils.py:36-37)."""


class VegaArinyoError(VegaModelError):
    """(vega_tpu/utils.py:39-40)"""


def resolve_dtype(dtype=None):
    """The interface's dtype: `dtype` when given (torch.float64 or
    torch.float32), else read from VEGA_TPU_X64 as vega_tpu/__init__.py:22
    reads it: '0' is vega_tpu's f32 throughput mode, anything else f64."""
    if dtype is None:
        return (torch.float32 if os.environ.get('VEGA_TPU_X64', '1') == '0'
                else torch.float64)
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f'the port runs in float64 or float32, not {dtype}')
    return dtype


def to_tensor(x, device, dtype=torch.float64):
    """Copy of the host array `x`, taken as f64 and rounded to `dtype` on
    the host, on `device` (explicit: torch's default is f32): host arrays
    stay f64 and are cast once, and an f32 copy reaches the device with
    no f64 tensor made on the way (as vega_tpu's jnp.asarray of an f64
    array under VEGA_TPU_X64=0). A tensor `x` is cast where it lies and
    then moved (itself when it already has the dtype and device)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).to(device)
    host = np.asarray(x, dtype=np.float64)
    return torch.tensor(host.astype({torch.float64: np.float64,
                                     torch.float32: np.float32}[dtype]),
                        device=device)


def col(x, n_trailing):
    """Batch-axis helper: a (B,) tensor becomes (B, 1, ..., 1) with
    `n_trailing` singleton axes so it broadcasts against an unbatched
    grid; Python scalars and 0-d tensors pass through unchanged."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return x.reshape((-1,) + (1,) * n_trailing)
    return x


def host_row(x, ndim):
    """A saved model component as a host array of `ndim` axes: one row
    (1, ...) of a batched tensor, or an unbatched one."""
    x = x.detach()
    if x.dim() == ndim + 1 and x.shape[0] == 1:
        x = x[0]
    if x.dim() != ndim:
        raise ValueError(f'a component of shape {tuple(x.shape)} is not '
                         f'one row of {ndim} axes')
    return x.cpu().numpy()


def np_sinc(x):
    """Unnormalized sinc with sinc(0) = 1 (host-side init work)."""
    x = np.asarray(x, dtype=float)
    out = np.ones_like(x)
    nz = x != 0
    out[nz] = np.sin(x[nz]) / x[nz]
    return out


def sinc(x):
    """Unnormalized sinc sin(x)/x of a tensor with sinc(0) = 1, safe to
    differentiate at 0 (vega_tpu/utils.py:44-54)."""
    safe = torch.where(x == 0, 1.0, x)
    return torch.where(x == 0, 1.0, torch.sin(safe) / safe)


def interp(x, xp, fp, left, right):
    """Piecewise-linear interpolant of (xp, fp) at the tensor x, `left` /
    `right` outside the table (jnp.interp's formula; differentiable in x
    with the segment's slope)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = torch.where(dx == 0, fp[i],
                    fp[i - 1] + (delta / torch.where(dx == 0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], left, f)
    return torch.where(x > xp[-1], right, f)


def _tracer_bias_beta(params, name):
    """Resolve (bias, beta) for one tracer from any two of
    (bias, bias_eta, beta) — reference: utils.py:45-82. Values may be
    floats or (B,) tensors."""
    growth_rate = params.get('growth_rate', 0.970386)

    bias = params.get('bias_' + name, None)
    bias_eta = params.get('bias_eta_' + name, None)
    beta = params.get('beta_' + name, None)

    err_msg = ('For each tracer, specify two of (bias, bias_eta, beta). '
               f'Offending tracer: {name}')

    if bias is None:
        if bias_eta is None or beta is None:
            raise ValueError(err_msg)
        bias = bias_eta * growth_rate / beta

    if bias_eta is None and (bias is None or beta is None):
        raise ValueError(err_msg)

    if beta is None:
        if bias is None or bias_eta is None:
            raise ValueError(err_msg)
        beta = bias_eta * growth_rate / bias

    return bias, beta


def bias_beta(params, tracer1_name, tracer2_name):
    """(bias1, beta1, bias2, beta2) for a tracer pair
    (reference: utils.py:85-108)."""
    bias1, beta1 = _tracer_bias_beta(params, tracer1_name)
    if tracer1_name == tracer2_name:
        bias2, beta2 = bias1, beta1
    else:
        bias2, beta2 = _tracer_bias_beta(params, tracer2_name)
    return bias1, beta1, bias2, beta2


def find_file(path):
    """Resolve a path: as given, then under vega_tpu/models, the repo's
    tests/ and the repo root (vega_tpu/utils.py:174-210 without the
    read-only reference checkout)."""
    input_path = Path(os.path.expandvars(str(path)))
    if input_path.is_file():
        return input_path
    for cand in (JAX_PACKAGE_DIR / 'models' / input_path,
                 REPO_ROOT / 'tests' / input_path,
                 REPO_ROOT / input_path):
        if cand.is_file():
            return cand
    raise RuntimeError(f'The path/file does not exist: {input_path}')


# The masked inverse covariances and log-determinants of a process, by
# content (vega_tpu/utils.py:210-283 keeps the same caches): the
# interfaces a process builds on the same data (a fit's dense and grid
# interfaces, the f64 and f32 ones, variants of one dataset) factorize
# each covariance once. The inverses are read-only and held up to
# VEGA_TPU_INVCOV_CACHE_MB MiB (vega_tpu's budget, default 4096), read at
# each insertion as vega_tpu reads it, the oldest dropped first.
_INVCOV_CACHE = {}
_LOGDET_CACHE = {}


def _cov_key(cov_mat, data_mask):
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(cov_mat).view(np.uint8))
    h.update(np.ascontiguousarray(data_mask).view(np.uint8))
    h.update(repr((cov_mat.shape, str(cov_mat.dtype))).encode())
    return h.digest()


def compute_masked_invcov(cov_mat, data_mask):
    """Masked inverse covariance (reference: utils.py:271-298), computed
    once per content and process; the array returned is read-only."""
    key = _cov_key(cov_mat, data_mask)
    if key in _INVCOV_CACHE:
        return _INVCOV_CACHE[key]
    masked_cov = cov_mat[np.ix_(data_mask, data_mask)]
    try:
        np.linalg.cholesky(cov_mat)
    except np.linalg.LinAlgError:
        print('WARNING: Full matrix is not positive definite')
    try:
        np.linalg.cholesky(masked_cov)
    except np.linalg.LinAlgError:
        print('WARNING: Reduced matrix is not positive definite')
    out = np.linalg.inv(masked_cov)
    out.flags.writeable = False
    budget = int(float(os.environ.get('VEGA_TPU_INVCOV_CACHE_MB', '4096'))
                 * 2 ** 20)
    if out.nbytes <= budget:
        held = sum(v.nbytes for v in _INVCOV_CACHE.values())
        while held + out.nbytes > budget:
            held -= _INVCOV_CACHE.pop(next(iter(_INVCOV_CACHE))).nbytes
        _INVCOV_CACHE[key] = out
    return out


def compute_log_cov_det(cov_mat, data_mask):
    """log|C| of the masked covariance (reference: utils.py:301-318),
    computed once per content and process."""
    key = _cov_key(cov_mat, data_mask)
    if key not in _LOGDET_CACHE:
        masked_cov = cov_mat[np.ix_(data_mask, data_mask)]
        _LOGDET_CACHE[key] = float(np.linalg.slogdet(masked_cov)[1])
    return _LOGDET_CACHE[key]


def get_blinding(blind_pars, blinding_strat):
    """Parameter-level blinding offsets (vega_tpu/utils.py:289-323). The
    offsets files live on NERSC only: for desi_y1 / desi_y3 there is no
    file and this returns None, any other strategy raises, and nothing is
    downloaded."""
    if blinding_strat is None:
        # vega_tpu's assertion, raised whatever python's -O says
        raise AssertionError('Blinding failed, do not run!!!')
    print(f'Blinding parameters: {blind_pars}')

    if ('ap' in blind_pars) or ('at' in blind_pars) or ('alpha' in blind_pars):
        blinding_type = 'bao'
    elif ('growth_rate' in blind_pars) or ('phi_smooth' in blind_pars):
        blinding_type = 'full-shape'
    else:
        raise ValueError(f'No blinding implemented for parameters {blind_pars}')

    blinding_choices = {
        'desi_y1': {'full-shape': None, 'bao': None},
        'desi_y3': {'full-shape': None, 'bao': None},
    }

    if blinding_strat not in blinding_choices:
        raise ValueError(f'Unknown blinding version: {blinding_strat}.')

    blinding_file = blinding_choices[blinding_strat][blinding_type]
    if blinding_file is None:
        return None

    blinding = {}
    with np.load(blinding_file) as file:
        for par in blind_pars:
            if par not in VEGA_BLINDED_PARS:
                raise ValueError(f'Blinding for parameter {par} not implemented.')
            blinding[par] = float(file[par])
    return blinding


def apply_blinding(params, blinding):
    """Add each blinded name's offset pi - exp(v^2) to `params`
    (vega_tpu/utils.py:326-330). The values may be floats or (B,)
    tensors: each entry is replaced, never changed in place, so a leaf
    that requires grad stays a leaf."""
    for par, val in blinding.items():
        params[par] = params[par] + (np.pi - np.exp(val ** 2))
    return params


def convert_instance_to_dictionary(inst):
    """Public attributes of an object as a dict (vega_tpu/utils.py:
    333-336)."""
    return {name: getattr(inst, name) for name in dir(inst)
            if not name.startswith('__')}


def compute_gauss_smoothing(sigma_par, sigma_trans, k_par_grid, k_trans_grid):
    """Anisotropic Gaussian smoothing factor (vega_tpu/utils.py:339-342)."""
    return np.exp(-(k_par_grid ** 2 * sigma_par ** 2
                    + k_trans_grid ** 2 * sigma_trans ** 2) / 2)


def compute_kn_smoothing(scale_par, k_grid, n):
    """k^n smoothing factor (vega_tpu/utils.py:345-347)."""
    return np.exp(-scale_par ** 2 * k_grid ** n / 2)


# the growth machinery lives in cosmo.py; re-exported from utils as
# vega_tpu re-exports it (vega_tpu/utils.py:350-355)
from .cosmo import (get_growth_interp, growth_function,  # noqa: E402,F401
                    growth_integrand, hubble)
