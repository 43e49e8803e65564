"""Gaussian mock generation: adapting a fiducial model vector to the data
grid, the (scaled) covariance Cholesky factor, and the draw itself.

Copy of vega_tpu/mocks.py:24-71 (numpy only, pinned to the JAX package
by tests/test_torch_host.py). Mock semantics follow the reference
(data.py:689-760, analysis.py:164-222): mock = fiducial + L @ N(0, 1)
with L = cholesky(scale * C); the host paths (`Data.create_monte_carlo`,
`Analysis.run_monte_carlo`) keep the legacy numpy global RNG, so seeded
host mocks are the same numbers in both packages. The device-batched
engine (parallel.MonteCarloEngine.generate_mocks) draws with a
torch.Generator instead.
"""

from __future__ import annotations

import numpy as np


def match_to_data_grid(fiducial, data):
    """Adapt a fiducial model vector to the data grid.

    Accepts either a vector already on the data grid or one on the
    (distorted) model grid, which is masked down; anything else is an
    error (reference: data.py:735-747, analysis.py:183-194).
    """
    fiducial = np.asarray(fiducial)
    if fiducial.size == data.full_data_size:
        return fiducial
    model_size = data.dist_model_coordinates.rp_grid.size
    if fiducial.size != model_size:
        raise ValueError(
            'Could not match fiducial model to data or model size.')
    grid_mask = data.dist_model_coordinates.get_mask_to_other(
        data.data_coordinates)
    return fiducial[grid_mask]


def scaled_cholesky(cov, scale=1.0, mask=None):
    """Lower Cholesky factor of scale * cov, optionally restricted to the
    masked bins first (reference: data.py:726-733)."""
    cov = np.asarray(cov)
    if mask is not None:
        cov = cov[np.ix_(mask, mask)]
    return np.linalg.cholesky(scale * cov)


def gaussian_draw(fiducial, chol, rng=None):
    """fiducial + L @ N(0, 1). With rng=None the legacy numpy global RNG
    is used (matching the reference's np.random.seed/randn sequences,
    data.py:749-756)."""
    n = chol.shape[0]
    noise = np.random.randn(n) if rng is None else rng.standard_normal(n)
    return np.asarray(fiducial) + chol @ noise


def resolve_scale(scale, corr_item=None, name=None):
    """Normalize the per-correlation covariance scale argument: a scalar
    applies everywhere, a dict is looked up by name, None falls back to
    the correlation's cov_rescale (reference: analysis.py:139-151)."""
    if isinstance(scale, dict):
        return scale.get(name, 1.)
    if scale is not None:
        return scale
    if corr_item is not None and corr_item.cov_rescale is not None:
        return corr_item.cov_rescale
    return None
