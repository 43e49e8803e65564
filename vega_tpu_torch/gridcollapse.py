"""Grid collapse: the factored quadratic form as a function of the
nonlinear scale parameters (ap, at and friends).

Counterpart of vega_tpu/gridcollapse.py. The model stays linear in the
coefficient vector c; only the basis moves with the grid parameters g:

    chi2(c, g) = s(g) - 2 dc.y(g) + dc.A(g) dc,     dc = c - c0

with A(g) = V Ci V', y(g) = V Ci d - A c0 and s(g) = chi2(c0, g). The
node sweep (`build_grid_payload`) evaluates A(g), e(g) = V Ci d and c0
exactly at Chebyshev-Gauss nodes on the device: per chunk of nodes one
spline + Legendre kernel launch over nodes x T basis rows, then
W = V Ci as one f64 GEMM. The node tensors come back to the host, where
the Chebyshev transform, the error-budgeted mode selection and the SVD
compression run as vega_tpu's numpy, copied here as is (pinned by
tests/test_torch_grid.py). Each evaluation (`grid_corr_chi2`) is then a
gather of the retained Chebyshev modes and two small f64 GEMMs per row
block, batched over rows. There is no double-single f32 path: the card
has f64 GEMMs.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .utils import DTYPE

# Sampled parameters that move basis rows instead of coefficients
# (vega_tpu/gridcollapse.py:65-87).
ALPHA_LIKE = {
    'ap', 'at', 'aiso', 'epsilon', 'phi', 'alpha',
    'ap_full', 'at_full', 'aiso_full', 'epsilon_full',
    'phi_full', 'alpha_full', 'phi_smooth', 'alpha_smooth',
}


def is_known_grid_param(name):
    return (name in ALPHA_LIKE or name.startswith('alpha_smooth_')
            or name.startswith('drp_')
            or name.startswith('sigma_velo_disp_'))


@dataclass(frozen=True)
class GridSpec:
    """The node grid: parameter names, domains, per-dimension node counts
    and the reference values substituted into the coefficient program
    (vega_tpu/gridcollapse.py:90-120)."""
    names: tuple
    lo: tuple
    hi: tuple
    degrees: tuple
    ref: tuple

    def __post_init__(self):
        for field, kind in (('names', str), ('lo', float), ('hi', float),
                            ('degrees', int), ('ref', float)):
            object.__setattr__(self, field,
                               tuple(kind(v) for v in getattr(self, field)))

    @property
    def n_nodes(self):
        return int(np.prod(self.degrees))

    def __repr__(self):
        dims = ', '.join(
            f'{n}: [{lo:.4g}, {hi:.4g}] x{d}'
            for n, lo, hi, d in zip(self.names, self.lo, self.hi,
                                    self.degrees))
        return f'GridSpec({dims})'


# --------------------------------------------------------------------------
# Chebyshev machinery (host side)
# --------------------------------------------------------------------------
def cheb_nodes(n):
    """Chebyshev-Gauss points on (-1, 1), ascending."""
    k = np.arange(n)
    return np.sort(np.cos((2 * k + 1) * np.pi / (2 * n)))


def cheb_transform_matrix(n):
    """(n, n) matrix M with a = M @ f mapping values at `cheb_nodes(n)`
    to Chebyshev coefficients (exact for polynomials of degree < n)."""
    x = cheb_nodes(n)
    theta = np.arccos(x)
    k = np.arange(n)[:, None]
    mat = np.cos(k * theta[None, :]) * (2.0 / n)
    mat[0] *= 0.5
    return mat


# --------------------------------------------------------------------------
# Per-evaluation (device, batched over rows)
# --------------------------------------------------------------------------
# chi^2 wall strength outside the node domain, per unit of squared
# normalized excess (vega_tpu/gridcollapse.py:154-164).
GRID_WALL_CHI2 = 1e8


def cheb_values(x, n):
    """(B, n): T_0(x) .. T_{n-1}(x) of a (B,) tensor by the three-term
    recurrence."""
    vals = [torch.ones_like(x), x]
    for _ in range(2, n):
        vals.append(2 * x * vals[-1] - vals[-2])
    return torch.stack(vals[:n], dim=-1)


def grid_tvecs(spec, params, n_rows):
    """Per-dimension Chebyshev values at the domain-clamped normalized
    point of each row, and the summed squared normalized excess outside
    the domain (vega_tpu/gridcollapse.py:167-186). params[name] is a
    (B,) or (1,) tensor. Returns (tuple of (B, deg) tensors,
    excess (B,))."""
    tvecs = []
    excess = 0.0
    for name, lo, hi, deg in zip(spec.names, spec.lo, spec.hi,
                                 spec.degrees):
        x = ((2.0 * params[name] - (lo + hi)) / (hi - lo)).expand(n_rows)
        one = torch.ones((), dtype=x.dtype, device=x.device)
        # torch.maximum / torch.minimum, not torch.clamp: at a tie their
        # subgradient is 1/2, jnp.maximum's and jnp.clip's, so a point
        # exactly on the domain's end (an L-BFGS-B limit) gets vega_tpu's
        # gradient and Hessian
        excess = excess + torch.maximum(torch.abs(x) - one, 0.0 * one) ** 2
        tvecs.append(cheb_values(torch.minimum(torch.maximum(x, -one), one),
                                 deg))
    return tuple(tvecs), excess


def psi_from_modes(tvecs, modes):
    """(B, M) tensor-basis values of the retained modes: psi[b, m] =
    prod_d T_{modes[d, m]}(x_d[b]), modes a (D, M) int64 tensor
    (vega_tpu/gridcollapse.py:189-200)."""
    psi = tvecs[0][:, modes[0]]
    for d in range(1, len(tvecs)):
        psi = psi * tvecs[d][:, modes[d]]
    return psi


def grid_corr_chi2(corr_payload, tvecs, coeffs):
    """(B,) chi^2 of one correlation from its device payload
    (vega_tpu/gridcollapse.py:233-264 with use_ds=False): per row,
    A = (psi_A B_A) F_A and (y, s) = (psi_sy B_sy) F_sy, then
    s - 2 dc.y + dc.A dc. coeffs: (B, T)."""
    t = corr_payload['cref'].shape[0]
    dc = coeffs - corr_payload['cref']
    psi_a = psi_from_modes(tvecs, corr_payload['modes_A'])
    p_a = (psi_a @ corr_payload['B_A']) @ corr_payload['F_A']
    psi_sy = psi_from_modes(tvecs, corr_payload['modes_sy'])
    p_sy = (psi_sy @ corr_payload['B_sy']) @ corr_payload['F_sy']
    a_mat = p_a.reshape(-1, t, t)
    y = p_sy[:, :t]
    s = p_sy[:, t]
    return (s - 2.0 * torch.sum(dc * y, dim=-1)
            + torch.sum(dc * (a_mat @ dc[..., None])[..., 0], dim=-1))


def device_payload(payload, device):
    """The per-evaluation arrays of a host payload as device tensors
    (f64; mode indices int64)."""
    out = {'__grid__': payload['__grid__']}
    for name, corr in payload.items():
        if name == '__grid__':
            continue
        out[name] = {
            part: torch.as_tensor(
                np.asarray(corr[part]),
                dtype=torch.int64 if part.startswith('modes') else DTYPE,
                device=device)
            for part in ('B_A', 'F_A', 'modes_A', 'B_sy', 'F_sy',
                         'modes_sy', 'cref')}
    return out


# --------------------------------------------------------------------------
# Payload files (the format of vega_tpu/gridcollapse.py:376-402)
# --------------------------------------------------------------------------
def save_payload(path, payload):
    spec = payload['__grid__']
    arrays = {'__spec__': np.array(
        repr((spec.names, spec.lo, spec.hi, spec.degrees, spec.ref)))}
    for name, corr in payload.items():
        if name == '__grid__':
            continue
        for part, arr in corr.items():
            arrays[f'{name}::{part}'] = arr
    tmp = f'{path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as fh:
        np.savez(fh, **arrays)          # file object: no suffix magic
    os.replace(tmp, path)


def load_payload(path):
    from ast import literal_eval
    with np.load(path) as data:
        names, lo, hi, degrees, ref = literal_eval(
            str(data['__spec__']))
        payload = {'__grid__': GridSpec(names, lo, hi, degrees, ref)}
        for key in data.files:
            if key == '__spec__':
                continue
            name, part = key.split('::', 1)
            payload.setdefault(name, {})[part] = data[key]
    return payload


# --------------------------------------------------------------------------
# Mode selection and compression (host numpy, vega_tpu's code as is)
# --------------------------------------------------------------------------
def _mode_probe_psi(spec, modes, n_probe, rng):
    """(n_probe, M) tensor-product Chebyshev basis values of the given
    ``modes`` ((D, M) per-dimension indices) at a uniform probe cloud
    over the normalized domain (host numpy). Built per present mode
    rather than per full-tensor node so sparse (combination-technique)
    mode sets never materialize the prod(degrees) tensor."""
    psi = np.ones((n_probe, modes.shape[1]))
    for d, deg in enumerate(spec.degrees):
        x = rng.uniform(-1.0, 1.0, size=n_probe)
        tv = np.empty((n_probe, deg))
        tv[:, 0] = 1.0
        if deg > 1:
            tv[:, 1] = x
        for k in range(2, deg):
            tv[:, k] = 2.0 * x * tv[:, k - 1] - tv[:, k - 2]
        psi *= tv[:, modes[d]]
    return psi


def _budgeted_cut(weight, sens_cols, psi, err_of_delta, budget):
    """Smallest weight-ranked retained set whose measured interpolant
    error at the probe cloud stays within ``budget``. Returns indices
    into the rows of ``sens_cols`` (ascending)."""
    n = weight.shape[0]
    order = np.argsort(-weight)                 # strongest first

    def max_err(n_keep):
        dropped = order[n_keep:]
        if dropped.size == 0:
            return 0.0
        return err_of_delta(psi[:, dropped] @ sens_cols[dropped])

    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi) // 2
        if max_err(mid) <= budget:
            hi = mid
        else:
            lo = mid + 1
    return np.sort(order[:lo])


def select_payload_modes(coef, t, spec, mode_budget, dc_max, modes=None):
    """Retained-mode row indices (kept_A, kept_sy) for the two payload
    blocks of one correlation's Chebyshev coefficient matrix ``coef``
    ((n_modes_present, t*t + t + 1), columns ordered [A, y, s]); each
    cutoff is the smallest weight-ranked set whose measured error at a
    uniform probe cloud stays within half of ``mode_budget``
    (vega_tpu/gridcollapse.py:447-513)."""
    n_present = coef.shape[0]
    if modes is None:
        modes = np.stack(np.unravel_index(
            np.arange(n_present), spec.degrees)).astype(np.int32)
    if mode_budget <= 0 or n_present <= 1:
        idx = np.arange(n_present)
        return idx, idx

    n_probe = int(os.environ.get('VEGA_TPU_GRID_PROBES', 512))
    rng = np.random.default_rng(20260819)
    psi = _mode_probe_psi(spec, modes, n_probe, rng)

    a_coef = coef[:, :t * t]
    y_coef = coef[:, t * t:t * t + t]
    s_coef = coef[:, t * t + t]
    half = 0.5 * mode_budget

    # A block: err(x) = dc_max^2 ||dA(x)||_F (JL sketch)
    n_sketch = min(16, t * t)
    sketch = rng.normal(size=(t * t, n_sketch)) / np.sqrt(n_sketch)
    sens_a = dc_max ** 2 * (a_coef @ sketch)
    kept_a = _budgeted_cut(
        np.linalg.norm(sens_a, axis=1), sens_a, psi,
        lambda delta: float(np.linalg.norm(delta, axis=1).max()), half)

    # sy block: err(x) = |ds(x)| + 2 dc_max ||dy(x)||
    sens_sy = np.concatenate(
        [s_coef[:, None], 2.0 * dc_max * y_coef], axis=1)
    kept_sy = _budgeted_cut(
        np.abs(s_coef) + 2.0 * dc_max * np.linalg.norm(y_coef, axis=1),
        sens_sy, psi,
        lambda delta: float((np.abs(delta[:, 0])
                             + np.linalg.norm(delta[:, 1:], axis=1)).max()),
        half)
    return kept_a, kept_sy


def _svd_compress(coef, svd_tol):
    """(B, F) with B @ F ~= coef, rank chosen by the relative Frobenius
    tail of the singular values."""
    u, s, vt = np.linalg.svd(coef, full_matrices=False)
    if s.size and s[0] > 0:
        tail = np.sqrt(np.cumsum(s[::-1] ** 2))[::-1]
        keep = int(np.searchsorted(-tail, -svd_tol * tail[0]))
        rank = max(1, min(s.size, keep if keep > 0 else 1))
    else:                                               # pragma: no cover
        rank = 1
    return (np.ascontiguousarray(u[:, :rank]),
            np.ascontiguousarray(s[:rank, None] * vt[:rank]))


def finalize_corr_payload(coef, modes, c0, spec, mode_budget, dc_max,
                          svd_tol):
    """Per-correlation payload from a (possibly sparse) Chebyshev
    coefficient matrix (vega_tpu/gridcollapse.py:1127-1164): validated
    mode truncation per block, then an SVD compression of each block."""
    t = c0.shape[0]
    if modes is None:
        modes = np.stack(np.unravel_index(
            np.arange(coef.shape[0]), spec.degrees)).astype(np.int32)
    kept_a, kept_sy = select_payload_modes(
        coef, t, spec, mode_budget, dc_max, modes=modes)
    b_a, f_a = _svd_compress(coef[kept_a, :t * t], svd_tol)
    b_sy, f_sy = _svd_compress(coef[kept_sy, t * t:], svd_tol)
    return {
        'B_A': b_a, 'F_A': f_a,
        'modes_A': np.ascontiguousarray(modes[:, kept_a]),
        'B_sy': b_sy, 'F_sy': f_sy,
        'modes_sy': np.ascontiguousarray(modes[:, kept_sy]),
        'cref': c0,
        'dc_max': np.float64(dc_max),
    }


# --------------------------------------------------------------------------
# Node schedules (host numpy, vega_tpu's code as is)
# --------------------------------------------------------------------------
def _level_degrees(full):
    """Per-dimension degree ladder for the combination levels
    (0, 1, 2) -> (1, mid, full)."""
    full = int(full)
    if full <= 2:
        return (1, full) if full == 2 else (1,)
    mid = max(2, (full + 1) // 2)
    if mid >= full:                                       # pragma: no cover
        mid = full - 1
    return (1, mid, full)


def plan_components(spec, mode='auto', order=3, max_tensor=None):
    """Node-grid components [(degrees_vec, coeff)]: one full tensor, or
    for 3+ wide dimensions the anisotropic combination schedule
    (vega_tpu/gridcollapse.py:630-702)."""
    import itertools

    if max_tensor is None:
        max_tensor = int(os.environ.get('VEGA_TPU_GRID_MAX_TENSOR', 4096))
    d = len(spec.degrees)
    use_comb = (mode == 'always'
                or (mode == 'auto' and d >= 3
                    and spec.n_nodes > int(max_tensor)))
    if mode == 'never' or not use_comb:
        return [(tuple(spec.degrees), 1.0)]

    ladders = [_level_degrees(f) for f in spec.degrees]
    tops = [len(lad) - 1 for lad in ladders]

    def member(lvl):
        if any(v > t for v, t in zip(lvl, tops)):
            return False
        n_active = sum(v > 0 for v in lvl)
        if n_active <= 2:
            return True
        return n_active <= order and max(lvl) <= 1

    index_set = {lvl for lvl in itertools.product(range(3), repeat=d)
                 if member(lvl)}
    components = []
    for lvl in sorted(index_set):
        coeff = 0.0
        for z in itertools.product((0, 1), repeat=d):
            up = tuple(a + b for a, b in zip(lvl, z))
            if up in index_set:
                coeff += (-1.0) ** sum(z)
        if coeff != 0.0:
            components.append(
                (tuple(ladders[i][v] for i, v in enumerate(lvl)), coeff))
    return components


def component_nodes(spec, degrees):
    """(prod(degrees), D) node coordinates of one tensor component in
    PARAMETER units (C order, first dimension outermost)."""
    axes = [0.5 * (lo + hi) + 0.5 * (hi - lo) * cheb_nodes(deg)
            for lo, hi, deg in zip(spec.lo, spec.hi, degrees)]
    mesh = np.meshgrid(*axes, indexing='ij')
    return np.stack([m.ravel() for m in mesh], axis=-1)


# --------------------------------------------------------------------------
# Coefficient range and the node sweep
# --------------------------------------------------------------------------
def measure_dc_max(vega, sample_names, spec, c0s):
    """Measured bound on ||c(theta) - c0||_2 per correlation over the
    sampling box (vega_tpu/gridcollapse.py:516-610): the coefficient
    program at the box corners and 256 uniform draws (same seeds), grid
    parameters pinned at the spec reference; inflated by 1.25 and
    floored at 1. Returns (dc_max {corr: float}, note)."""
    base = {}
    varying = []
    for name in sorted(sample_names):
        if name in spec.names:
            continue
        base[name] = float(vega.params.get(name, 0.0))
        limits = vega.sample_params['limits'].get(name)
        if limits is not None and limits[0] is not None \
                and limits[1] is not None:
            varying.append((name, float(limits[0]), float(limits[1])))
    for name, ref in zip(spec.names, spec.ref):
        base[name] = float(ref)

    n_draws = int(os.environ.get('VEGA_TPU_GRID_DC_DRAWS', 256))
    rng = np.random.default_rng(20260820)
    n_var = len(varying)
    if n_var == 0 or n_draws <= 0:
        return ({name: 1.0 for name in c0s},
                'no finite-limit non-grid sampled parameters varied')

    if n_var <= 8:
        corners = np.stack(np.meshgrid(
            *[[lo, hi] for _, lo, hi in varying],
            indexing='ij')).reshape(n_var, -1).T
    else:
        corners = np.where(
            rng.integers(0, 2, size=(256, n_var)).astype(bool),
            np.array([hi for _, _, hi in varying]),
            np.array([lo for _, lo, _ in varying]))
    uniform = np.stack(
        [rng.uniform(lo, hi, size=n_draws) for _, lo, hi in varying],
        axis=-1)
    draws = np.concatenate([corners, uniform])              # (P, n_var)

    batch = dict(base)
    for i, (name, _, _) in enumerate(varying):
        batch[name] = draws[:, i]
    coeffs = vega.coefficient_rows(batch, list(c0s))

    out = {}
    for name, c0 in c0s.items():
        c = coeffs[name].cpu().numpy()
        measured = float(np.linalg.norm(c - c0[None, :], axis=1).max())
        out[name] = max(1.0, 1.25 * measured)
    note = (f'{corners.shape[0]} corners + {n_draws} uniform draws over '
            + ', '.join(f'{n} in [{lo:g}, {hi:g}]' for n, lo, hi in varying))
    return out, note


def _sweep(vega, sample_names, spec, nodes, sweep_chunk):
    """A(g), e(g) per node and c0 per correlation, on the device, in
    chunks of `sweep_chunk` nodes (vega_tpu/gridcollapse.py:812-961).
    Returns ({corr: {'A': (N, T, T), 'e': (N, T)}} host arrays,
    {corr: c0 (T,)}, bad (N,) bool)."""
    base = {name: float(vega.params.get(name, 0.0))
            for name in sample_names}
    pk_caches = {}
    parts, c0s, bad = {}, {}, []
    for start in range(0, nodes.shape[0], sweep_chunk):
        chunk = nodes[start:start + sweep_chunk]
        params = dict(base)
        for i, name in enumerate(spec.names):
            params[name] = chunk[:, i]
        payload, c0_chunk, bad_chunk = vega._grid_collapse_node(
            params, frozenset(sample_names), spec.names, pk_caches)
        for name, tensors in payload.items():
            for piece, arr in tensors.items():
                parts.setdefault(name, {}).setdefault(piece, []).append(
                    arr.cpu().numpy())
        for name, c0 in c0_chunk.items():
            c0 = c0.cpu().numpy()
            if name in c0s and not np.allclose(c0s[name], c0):
                raise AssertionError(
                    f'coefficient vector varies across sweep chunks for '
                    f'{name}')
            c0s[name] = c0
        bad.append(bad_chunk.cpu().numpy())
    nodes_out = {name: {piece: np.concatenate(arrs)
                        for piece, arrs in pieces.items()}
                 for name, pieces in parts.items()}
    return nodes_out, c0s, np.concatenate(bad)


def build_grid_payload(vega, sample_names, grid_names, spec,
                       sweep_chunk=None, svd_tol=None, mode_budget=None,
                       components=None, n_validate=None, stats=None):
    """Run the node sweep on the device and build the per-correlation
    payloads on the host (vega_tpu/gridcollapse.py:717-1110).

    Returns {'__grid__': spec, corr_name: {'B_A', 'F_A', 'modes_A',
    'B_sy', 'F_sy', 'modes_sy', 'cref', 'dc_max', 'probe_err'}} (host
    numpy). Correlations whose model does not stay factored are absent;
    the chi^2 evaluates those densely. `stats`, when a dict, receives
    the sweep and host times (s, the sweep synchronised) and the node
    count."""
    t_start = time.perf_counter()
    if sweep_chunk is None:
        sweep_chunk = int(os.environ.get('VEGA_TPU_GRID_SWEEP_CHUNK', 32))
    if svd_tol is None:
        svd_tol = float(os.environ.get('VEGA_TPU_GRID_SVD_TOL', 1e-12))
    if mode_budget is None:
        mode_budget = float(os.environ.get(
            'VEGA_TPU_GRID_MODE_BUDGET', 2e-4))
    if components is None:
        components = plan_components(spec)
    if n_validate is None:
        n_validate = int(os.environ.get(
            'VEGA_TPU_GRID_VALIDATE',
            8 if len(components) > 1 else 0))

    # Node list: every component's tensor grid back to back, plus the
    # validation probes at the end (C order within each component).
    comp_blocks = [component_nodes(spec, degs) for degs, _ in components]
    comp_sizes = [b.shape[0] for b in comp_blocks]
    if n_validate > 0:
        rng_val = np.random.default_rng(20260821)
        val_nodes = np.stack(
            [rng_val.uniform(lo + 0.02 * (hi - lo), hi - 0.02 * (hi - lo),
                             size=n_validate)
             for lo, hi in zip(spec.lo, spec.hi)], axis=-1)
        comp_blocks.append(val_nodes)
    nodes = np.concatenate(comp_blocks, axis=0)            # (N, G)
    n_nodes = nodes.shape[0]

    payload_nodes, c0s, bad = _sweep(vega, sample_names, spec, nodes,
                                     sweep_chunk)
    t_swept = time.perf_counter()
    if bad.any():
        first = nodes[np.argmax(bad)]
        raise ValueError(
            'Grid collapse: the model is out of bounds (spline range or '
            f'non-finite factor) at {int(bad.sum())} of {n_nodes} nodes, '
            f'first at {dict(zip(spec.names, first))}. Narrow the grid '
            'domain ([control] grid-domain-<param> = lo hi) or the '
            'sampling limits.')

    dc_maxes, dc_note = measure_dc_max(vega, sample_names, spec, c0s)
    if dc_maxes:
        worst = max(dc_maxes.values())
        print(f'INFO: grid collapse dc_max = {worst:.3g} '
              f'(coefficient range over {dc_note})', file=sys.stderr)

    # per-degree Chebyshev transform matrices, shared across components
    tmat_cache = {}

    def tmat(deg):
        if deg not in tmat_cache:
            tmat_cache[deg] = cheb_transform_matrix(deg)
        return tmat_cache[deg]

    data_vecs = {name: vega.data[name].masked_data_vec
                 for name in vega.corr_items}
    out = {'__grid__': spec}
    for name in vega.corr_items:
        if name not in payload_nodes:
            continue
        a_nodes = payload_nodes[name]['A']
        e_nodes = payload_nodes[name]['e']
        c0 = c0s[name]
        t = c0.shape[0]

        d_masked = data_vecs[name]
        inv_cov = np.asarray(vega.data[name].inv_masked_cov)
        d_ci_d = float(d_masked @ (inv_cov @ d_masked))

        # centered pieces, exact f64 on the host:
        #   y_q = e_q - A_q c0 ;  s_q = chi2(c0, g_q)
        y_nodes = e_nodes - np.einsum('qts,s->qt', a_nodes, c0)
        s_nodes = (d_ci_d - 2.0 * e_nodes @ c0
                   + np.einsum('t,qts,s->q', c0, a_nodes, c0))

        payload = np.concatenate(
            [a_nodes.reshape(n_nodes, t * t), y_nodes,
             s_nodes[:, None]], axis=1)                     # (N, D)
        n_cols = payload.shape[1]

        # Per-component Chebyshev transforms, accumulated (with the
        # telescoping combination weights) into the global sparse
        # tensor-mode set.
        lin_parts, coef_parts = [], []
        offset = 0
        for (degs, weight), size in zip(components, comp_sizes):
            block = payload[offset:offset + size]
            coef = block.reshape(tuple(degs) + (n_cols,))
            for axis, deg in enumerate(degs):
                coef = np.moveaxis(
                    np.tensordot(tmat(deg), coef, axes=(1, axis)),
                    0, axis)
            coef = coef.reshape(size, n_cols)
            midx = np.stack(np.unravel_index(np.arange(size), degs))
            lin_parts.append(np.ravel_multi_index(midx, spec.degrees))
            coef_parts.append(weight * coef)
            offset += size
        all_lin = np.concatenate(lin_parts)
        all_coef = np.concatenate(coef_parts, axis=0)
        uniq, inv = np.unique(all_lin, return_inverse=True)
        acc = np.zeros((uniq.size, n_cols))
        np.add.at(acc, inv, all_coef)
        modes = np.stack(np.unravel_index(uniq, spec.degrees)
                         ).astype(np.int32)                 # (D, M)

        corr_payload = finalize_corr_payload(
            acc, modes, c0, spec, mode_budget, dc_maxes[name], svd_tol)

        # Served-payload validation at the held-out probe points.
        probe_err = 0.0
        if n_validate > 0:
            exact_rows = payload[offset:offset + n_validate]
            tv_tables = {}
            for d, deg in enumerate(spec.degrees):
                x = ((2.0 * nodes[offset:offset + n_validate, d]
                      - (spec.lo[d] + spec.hi[d]))
                     / (spec.hi[d] - spec.lo[d]))
                tv = np.empty((n_validate, deg))
                tv[:, 0] = 1.0
                if deg > 1:
                    tv[:, 1] = x
                for k in range(2, deg):
                    tv[:, k] = 2.0 * x * tv[:, k - 1] - tv[:, k - 2]
                tv_tables[d] = tv

            def probe_psi(block_modes):
                psi = np.ones((n_validate, block_modes.shape[1]))
                for d in range(len(spec.degrees)):
                    psi *= tv_tables[d][:, block_modes[d]]
                return psi

            p_a = (probe_psi(corr_payload['modes_A'])
                   @ corr_payload['B_A']) @ corr_payload['F_A']
            p_sy = (probe_psi(corr_payload['modes_sy'])
                    @ corr_payload['B_sy']) @ corr_payload['F_sy']
            da = np.linalg.norm(p_a - exact_rows[:, :t * t], axis=1)
            dy = np.linalg.norm(
                p_sy[:, :t] - exact_rows[:, t * t:t * t + t], axis=1)
            ds = np.abs(p_sy[:, t] - exact_rows[:, t * t + t])
            dc_max = dc_maxes[name]
            probe_err = float(
                (ds + 2.0 * dc_max * dy + dc_max ** 2 * da).max())
            if probe_err > 5.0 * mode_budget and mode_budget > 0:
                print(f'WARNING: grid-collapse payload for {name} misses '
                      f'the dense collapse by up to chi^2 ~ {probe_err:.3g} '
                      f'at {n_validate} held-out probe points (budget '
                      f'{mode_budget:g}). Raise the per-dimension node '
                      'counts ([control] grid-nodes-<param>), the '
                      'interaction order ([control] grid-interaction-'
                      'order), or narrow the grid domains.',
                      file=sys.stderr)
        corr_payload['probe_err'] = np.float64(probe_err)
        out[name] = corr_payload

    if len(components) > 1:
        kept = {name: int(out[name]['modes_A'].shape[1])
                for name in out if name != '__grid__'}
        print(f'INFO: grid collapse combination schedule: '
              f'{len(components)} components, '
              f'{sum(comp_sizes)} swept nodes '
              f'(full tensor {spec.n_nodes}); retained A-modes {kept}',
              file=sys.stderr)
    if stats is not None:
        t_end = time.perf_counter()
        stats.update(sweep_s=t_swept - t_start, host_s=t_end - t_swept,
                     total_s=t_end - t_start, nodes=n_nodes)
    return out
