"""Batched likelihood evaluation, profile scans and Monte-Carlo mock fits
on one GPU.

Counterpart of vega_tpu/parallel/batch.py for one device (no mesh, no
axis name): `BatchedLikelihood` (:44-196) runs a batch in row chunks on
the interface's device, with the collapse or grid payload resident there
(VegaInterface caches its device copy); `batched_chi2_scan` (:421-485)
and `MonteCarloEngine` (:488-586) run every grid point or mock as one row
of a damped-Newton minimization on exact derivatives
(`_newton_minimize_batched`, :287-418, with
`VegaInterface.chi2_batch_derivatives` in place of jax.grad / jax.hessian
under jax.vmap). `BatchedLikelihood.traceable_log_lik` (:198-237) gives
the samplers' device loops a log-likelihood of device tensors with
nothing left to resolve on the host. Under a global covariance every
row is the joint quadratic form over the concatenated masked model, one
(B, n) x (n, n) f64 GEMM and a row-wise dot (VegaInterface._chi2_rows),
for the chi^2, its derivatives and the traceable log-likelihood alike;
MonteCarloEngine draws per-correlation mocks and refuses a global
covariance (vega_tpu's engine has none either). Everything runs in the
interface's dtype: under vega_tpu's f32 mode (VEGA_TPU_X64=0) the Newton
carries its f64 constants (the bound slack, the damping ladder, the
stopping and validity tests) as vega_tpu's f32 run carries them, in f32.
Sharding over several cards is not ported yet.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import mocks as mock_tools
from ..utils import to_tensor


class BatchedLikelihood:
    """chi^2 / log-likelihood over parameter batches ({name: (B,)
    values}) of one VegaInterface.

    chunk_rows bounds the rows in flight at once; None takes the
    interface's default for the path the names select."""

    def __init__(self, vega, chunk_rows=None):
        if chunk_rows is not None and int(chunk_rows) < 1:
            raise ValueError(f'chunk_rows must be positive, got {chunk_rows}')
        self.vega = vega
        self.chunk_rows = None if chunk_rows is None else int(chunk_rows)

    def chi2(self, param_batches):
        """(B,) tensor on the interface's device in its dtype."""
        return self.vega.chi2_batch(param_batches,
                                    chunk_rows=self.chunk_rows)

    def log_lik(self, param_batches):
        return self.vega.log_lik_batch(param_batches,
                                       chunk_rows=self.chunk_rows)

    def traceable_log_lik(self, names):
        """The log-likelihood as a function of a device tensor, for a
        sampler's device loop (`TraceableLogLik`)."""
        return TraceableLogLik(self.vega, names)


class TraceableLogLik:
    """(n, ndim) device tensor of physical parameter values, columns
    ordered as `names` -> (n,) log-likelihoods, equal to `log_lik_batch`
    on the same rows.

    Everything a call needs is resolved at construction and held here:
    the collapse or grid payload the names dispatch to and its device
    copy, the device data vectors, the covariance scales, the
    normalisation and the priors' normalisations. A call then runs
    device ops only: no host sync, no branch on a tensor's values, no
    allocation sized by values, so a CUDA graph can capture it. It reads
    the data vectors current at construction: `stale()` says when they
    have changed since (a Monte-Carlo mock), and the function must be
    built again."""

    def __init__(self, vega, names):
        self.vega = vega
        self.names = tuple(names)
        self._key = frozenset(self.names)
        if vega._chi2_data is None:
            vega.set_chi2_constants()
        self._data_key, self._host_vecs = vega._data_key()
        # the host collapse, its device copy and the device data vectors:
        # held so the interface's memos keep serving these very tensors
        self._collapsed = vega.get_collapsed(self._key)
        self._device_collapsed = vega._device_collapsed(self._collapsed)
        self._data_vecs = vega._device_data_vecs()
        self._cov_scales = vega._current_cov_scales()
        self._params = dict(vega.params)
        log_norm = float(vega._log_norm())
        for prior in vega.priors.values():
            log_norm += float(vega._gaussian_lik_prior(prior[1]))
        self.log_norm = log_norm

    def stale(self):
        return self.vega._data_key()[0] != self._data_key

    @torch.no_grad()
    def __call__(self, theta):
        local = dict(self._params)
        local.update({name: theta[:, i]
                      for i, name in enumerate(self.names)})
        local = self.vega._blinded(local)
        chi2 = self.vega._chi2_rows(
            local, theta.shape[0], names=self._key,
            collapsed=self._collapsed, cov_scales=self._cov_scales)
        return self.log_norm - 0.5 * chi2


# ----------------------------------------------------------------------
# Symmetric positive-definite solves (vega_tpu/parallel/batch.py:240-284)
# ----------------------------------------------------------------------
def _spd_cholesky(a):
    """Lower Cholesky factor of each (..., n, n) matrix; NaN throughout
    for a matrix that is not positive definite, as vega_tpu's unrolled
    factorization gives (the damping ladder and `valid` rely on it),
    never an exception."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float('nan')))


def _spd_solve(a, b):
    """Solve a @ x = b for symmetric positive-definite a (b: (..., n) or
    (..., n, m)) through its Cholesky factor; NaN where a is not
    positive definite."""
    if a.shape[-1] == 0:
        return b.clone()
    vector = b.dim() == a.dim() - 1
    x = torch.cholesky_solve(b[..., None] if vector else b, _spd_cholesky(a))
    return x[..., 0] if vector else x


def _spd_inv(a):
    return _spd_solve(a, torch.eye(a.shape[-1], dtype=a.dtype,
                                   device=a.device).expand(a.shape))


# ----------------------------------------------------------------------
# Batched damped Newton (vega_tpu/parallel/batch.py:287-418)
# ----------------------------------------------------------------------
def _project_active(x, g, lo, hi):
    """Active-set mask: coordinates pinned at a bound with the gradient
    pushing outward. Plain clip() of the full Newton step is not enough:
    its fixed points have (H^-1 g)_free = 0, which can hold with
    g_free != 0; the projected (KKT-reduced) system solves the free
    subspace exactly. Returns (active, projected gradient)."""
    eps = 1e-12 + 1e-9 * torch.abs(x)
    active = (((x <= lo + eps) & (g > 0))
              | ((x >= hi - eps) & (g < 0)))
    return active, torch.where(active, 0.0, g)


def _newton_step(x, g, h, lo, hi):
    """(x_new, projected gradient) of one damped-Newton step per row.
    Adaptive Levenberg damping: an indefinite Hessian makes the plain
    Cholesky solve NaN, so solve at a ladder of damping strengths and keep
    the least-damped finite step (the strongest approximates scaled
    gradient descent; no finite step: stay put)."""
    n_free = x.shape[-1]
    active, g_proj = _project_active(x, g, lo, hi)
    free = ~active
    h_proj = (torch.where(free[:, :, None] & free[:, None, :], h, 0.0)
              + torch.diag_embed(torch.where(active, 1.0, 0.0)))
    # max(n_free, 1) keeps the all-parameters-scanned case finite
    tr = (torch.abs(h_proj.diagonal(dim1=-2, dim2=-1).sum(-1))
          / max(n_free, 1) + 1e-12)
    eye = torch.eye(n_free, dtype=x.dtype, device=x.device)
    ladder = torch.tensor([1e-6, 1e-2, 1.0, 1e2], dtype=x.dtype,
                          device=x.device)
    lams = ladder[:, None] * tr                           # (4, B)
    steps = _spd_solve(h_proj + lams[..., None, None] * eye,
                       g_proj.expand(4, *g_proj.shape))  # (4, B, n)
    step = torch.zeros_like(g)
    for s in steps.flip(0):
        step = torch.where(torch.isfinite(s).all(-1, keepdim=True), s, step)
    return torch.minimum(torch.maximum(x - step, lo), hi), g_proj


def _fit_chunk(derivatives, x0, lo, hi, chunk, max_iterations, stats):
    """One chunk of rows: Newton steps while any row's own condition
    (it < max_iterations and max|projected gradient| > 1e-6) holds, a
    row whose condition failed frozen as vega_tpu's vmapped while_loop
    freezes it; then the Hessian again at the converged point."""
    n_rows = next(iter(chunk.values())).shape[0]
    x = x0.expand(n_rows, -1).clone()
    g = torch.full_like(x, float('inf'))
    iterations = 0
    for _ in range(max_iterations):
        # 0 with no free parameter
        g_norm = (g.abs().amax(dim=-1) if g.shape[-1]
                  else torch.zeros(n_rows, dtype=g.dtype, device=g.device))
        running = g_norm > 1e-6
        t0 = time.perf_counter()
        # the stopping test: the loop's one host sync per iteration
        go_on = bool(running.any())
        if stats is not None:
            stats['sync_s'] = stats.get('sync_s', 0.0) + (
                time.perf_counter() - t0)
        if not go_on:
            break
        _, grad, hess = derivatives(x, chunk)
        x_new, g_proj = _newton_step(x, grad, hess, lo, hi)
        x = torch.where(running[:, None], x_new, x)
        g = torch.where(running[:, None], g_proj, g)
        iterations += 1
    # curvature at the converged point (the loop's Hessian lags a step)
    chi2, _, hess = derivatives(x, chunk)
    cov = 2.0 * _spd_inv(hess)
    errors = torch.sqrt(torch.clamp(cov.diagonal(dim1=-2, dim2=-1), min=0))
    # valid: a stationary point AND a positive-definite curvature there
    valid = ((torch.abs(g) < 1e-3).all(-1)
             & torch.isfinite(cov).flatten(1).all(-1)
             & torch.isfinite(chi2))
    if stats is not None:
        stats.setdefault('iterations', []).append(iterations)
    return x, errors, cov, chi2, valid


def _newton_minimize_batched(derivatives, x0, lo, hi, batch_inputs,
                             max_iterations, chunk_per_device=None,
                             stats=None):
    """Batched damped-Newton minimizer on the device of x0.

    derivatives(x, chunk) -> (chi2 (b,), gradient (b, n), Hessian
    (b, n, n)) for x (b, n), `chunk` the rows' part of batch_inputs
    ({key: (B, ...) tensor}: per-mock data vectors for the Monte-Carlo
    engine, fixed scan values for the scan). lo, hi: (n,) bounds (+-inf
    for none).

    Rows run in chunks of `chunk_per_device` (default
    VEGA_TPU_FIT_CHUNK_PER_DEVICE, else 8: the Hessian graph of a dense
    row holds several model forwards), the last one padded by repeating
    the last row, as vega_tpu pads; each chunk runs its own loop, with one
    host sync per iteration for the stopping test (vega_tpu runs an
    on-device while_loop). `stats`, when a dict, receives the Newton
    iterations of each chunk, the seconds the host spent waiting in the
    stopping tests (`sync_s`) and the count of valid rows.

    Returns (x, errors, cov, chi2, valid) with the batch axis leading."""
    if chunk_per_device is None:
        chunk_per_device = int(os.environ.get(
            'VEGA_TPU_FIT_CHUNK_PER_DEVICE', 8))
    n_rows = next(iter(batch_inputs.values())).shape[0]
    chunk_rows = min(chunk_per_device, n_rows)
    pad = (-n_rows) % chunk_rows

    def padded(v):
        return torch.cat([v, v[-1:].expand(pad, *v.shape[1:])]) if pad else v

    inputs = {k: padded(v) for k, v in batch_inputs.items()}
    parts = [_fit_chunk(derivatives, x0, lo, hi,
                        {k: v[start:start + chunk_rows]
                         for k, v in inputs.items()},
                        max_iterations, stats)
             for start in range(0, n_rows + pad, chunk_rows)]
    out = tuple(torch.cat(pieces)[:n_rows] for pieces in zip(*parts))
    if stats is not None:       # the padding rows left out
        stats['valid_rows'] = stats.get('valid_rows', 0) + int(out[4].sum())
    return out


def _start_and_bounds(sample_params, names, device, dtype):
    """x0, lo, hi (n,) tensors from a sample_params dict; None limits
    become +-inf."""
    def tensor(values):
        return torch.tensor(values, dtype=dtype, device=device)

    limits = sample_params['limits']
    return (tensor([float(sample_params['values'][n]) for n in names]),
            tensor([-np.inf if limits[n][0] is None else float(limits[n][0])
                    for n in names]),
            tensor([np.inf if limits[n][1] is None else float(limits[n][1])
                    for n in names]))


def batched_chi2_scan(vega, grids, sample_params=None, max_iterations=100,
                      stats=None):
    """1D/2D profile chi^2 scan with every grid point minimized at once
    on the device: the grid is the batch axis of one damped-Newton
    minimization on exact derivatives (the reference re-runs MIGRAD at
    every point, analysis.py:53-124).

    grids: {param: 1D array of fixed values}, 1 or 2 entries. Returns a
    list in C order over the grid (outer loop = first grid param, as the
    serial Analysis.chi2_scan), each {free name: bestfit, scan name:
    fixed value, 'fval': chi^2}. The chi^2 is served by
    get_collapsed(free + scan names), with the data terms. stats as in
    _newton_minimize_batched."""
    if sample_params is None:
        sample_params = vega.sample_params
    scan_names = list(grids.keys())
    if not 1 <= len(scan_names) <= 2:
        raise ValueError('chi2 scan supports one or two parameters')
    free_names = [n for n in sample_params['limits'] if n not in scan_names]

    mesh_axes = np.meshgrid(*[np.asarray(grids[n]) for n in scan_names],
                            indexing='ij')
    scan_vals = np.stack([ax.ravel() for ax in mesh_axes], axis=-1)
    x0, lo, hi = _start_and_bounds(sample_params, free_names, vega.device,
                                   vega.dtype)

    def derivatives(x, chunk):
        point = chunk['point']
        return vega.chi2_batch_derivatives(
            free_names, x,
            fixed={n: point[:, i] for i, n in enumerate(scan_names)})

    x, _, _, chi2, _ = _newton_minimize_batched(
        derivatives, x0, lo, hi,
        {'point': to_tensor(scan_vals, vega.device, vega.dtype)},
        max_iterations, stats=stats)

    x = x.cpu().numpy()
    chi2 = chi2.cpu().numpy()
    results = []
    for g in range(scan_vals.shape[0]):
        row = {name: float(x[g, i]) for i, name in enumerate(free_names)}
        row.update({name: float(scan_vals[g, i])
                    for i, name in enumerate(scan_names)})
        row['fval'] = float(chi2[g])
        results.append(row)
    return results


class MonteCarloEngine:
    """Batched Monte-Carlo mock generation and fitting on the interface's
    device.

    Mocks are fiducial + z L^T with L the Cholesky factor of the masked
    covariance (reference: data.py:726-756) and z from a torch.Generator
    on the device seeded with `seed`. torch's generator is not
    jax.random: the draws differ from vega_tpu's by design, and the
    packages are compared by fitting identical mocks."""

    def __init__(self, vega):
        if vega._use_global_cov:
            raise ValueError(
                'MonteCarloEngine draws per-correlation mocks: under a '
                'global covariance use initialize_monte_carlo or '
                'Analysis.create_global_monte_carlo')
        self.vega = vega

    def generate_mocks(self, fiducial_model, num_mocks, seed=0, scale=None):
        """{name: (num_mocks, n_masked) tensor on the device}, the
        correlations in order, each from the same generator."""
        vega = self.vega
        generator = torch.Generator(device=vega.device)
        generator.manual_seed(seed)
        out = {}
        for name in vega.corr_items:
            data = vega.data[name]
            chol = mock_tools.scaled_cholesky(
                data.cov_mat, 1. if scale is None else scale,
                mask=data.data_mask)
            fid = mock_tools.match_to_data_grid(fiducial_model[name],
                                                data)[data.data_mask]
            noise = torch.randn((num_mocks, fid.size), generator=generator,
                                dtype=vega.dtype, device=vega.device)
            out[name] = (to_tensor(fid, vega.device, vega.dtype)[None, :]
                         + noise @ to_tensor(chol, vega.device, vega.dtype).T)
        return out

    def fit_mocks(self, mocks, sample_params=None, max_iterations=200,
                  use_kernel=True, stats=None):
        """Fit every mock ({name: (B, n_masked)} arrays or tensors) with
        the batched Newton, each against its own data vector with
        covariance scale 1. The parameters are [monte carlo]'s (else
        [sample]'s), or `sample_params`. The chi^2 takes
        get_collapsed(names, with_data_terms=False): the nuisance collapse
        with the data terms per mock, or the dense path (grid payloads
        bake the data in). Returns {'names', 'values', 'errors',
        'covariances', 'chisq', 'valid'} as numpy arrays, a row per
        mock."""
        vega = self.vega
        if sample_params is None:
            sample_params = (vega.mc_config['sample']
                             if vega.mc_config is not None
                             else vega.sample_params)
        names = list(sample_params['limits'].keys())
        x0, lo, hi = _start_and_bounds(sample_params, names, vega.device,
                                       vega.dtype)
        data_vecs = {name: to_tensor(mocks[name], vega.device, vega.dtype)
                     for name in vega.corr_items}
        cov_scales = {name: 1.0 for name in vega.corr_items}

        def derivatives(x, chunk):
            return vega.chi2_batch_derivatives(
                names, x, data_vecs=chunk, cov_scales=cov_scales,
                use_kernel=use_kernel)

        x, errors, cov, chi2, valid = _newton_minimize_batched(
            derivatives, x0, lo, hi, data_vecs, max_iterations, stats=stats)
        return {'names': names, 'values': x.cpu().numpy(),
                'errors': errors.cpu().numpy(),
                'covariances': cov.cpu().numpy(),
                'chisq': chi2.cpu().numpy(), 'valid': valid.cpu().numpy()}
