"""mu-wedge compression of 2D correlation functions.

A copy of vega_tpu/plots/wedges.py: an oversampled
(rp, rt) grid is histogrammed into (r, bin) count weights once at init;
applying a wedge is then one weighted matmul including covariance
propagation.
"""

from __future__ import annotations

import numpy as np


def bin_centers(bin_limits):
    return (bin_limits[1:] + bin_limits[:-1]) / 2


class Wedge:
    """Wedge weight matrix (reference: plots/wedges.py:4-80)."""

    get_bin_centers = staticmethod(bin_centers)

    def __init__(self, rp=(0., 200., 50), rt=(0., 200., 50),
                 r=(0., 200., 50), mu=(0.95, 1.0), scaling=10, abs_mu=False):
        rp_centers = bin_centers(
            np.linspace(rp[0], rp[1], scaling * rp[2] + 1))
        rt_centers = bin_centers(
            np.linspace(rt[0], rt[1], scaling * rt[2] + 1))
        rt_mesh, rp_mesh = np.meshgrid(rt_centers, rp_centers)
        r_mesh = np.sqrt(rp_mesh ** 2 + rt_mesh ** 2)
        mu_mesh = rp_mesh / r_mesh
        if abs_mu:
            mu_mesh = np.abs(mu_mesh)

        rp_bins = np.linspace(rp[0], rp[1], rp[2] + 1)
        rt_bins = np.linspace(rt[0], rt[1], rt[2] + 1)
        r_bins = np.linspace(r[0], r[1], r[2] + 1)

        rt_idx = np.digitize(rt_mesh, rt_bins) - 1
        rp_idx = np.digitize(rp_mesh, rp_bins) - 1
        r_idx = ((r_mesh - r[0]) / (r[1] - r[0]) * r[2]).astype(int)

        bins = rt_idx + rt[2] * rp_idx + rt[2] * rp[2] * r_idx

        # Coarse-bin centers for the cut checks
        rp_c = rp[0] + (rp_idx + 0.5) * (rp[1] - rp[0]) / rp[2]
        rt_c = rt[0] + (rt_idx + 0.5) * (rt[1] - rt[0]) / rt[2]
        r_c = np.sqrt(rp_c ** 2 + rt_c ** 2)

        mask = (mu_mesh >= mu[0]) & (mu_mesh <= mu[1])
        mask &= (r_c > r[0]) & (r_c < r[1]) & (r_idx < r[2])

        counts = np.bincount(bins[mask].flatten())
        positive_idx = np.where(counts != 0)
        self.weights = np.zeros((r[2], rt[2] * rp[2]))
        weights_idx = np.unravel_index(positive_idx, self.weights.shape)
        self.weights[weights_idx] = counts[positive_idx]
        self.r = bin_centers(r_bins)

    def __call__(self, data, covariance=None):
        """Apply the wedge; returns (r, wedge[, wedge_cov])
        (reference: plots/wedges.py:82-116)."""
        if covariance is None:
            cov_weight = np.ones(len(data))
        else:
            cov_weight = 1 / np.diagonal(covariance)

        norm = self.weights.dot(cov_weight)
        data_weights = self.weights * cov_weight
        mask = norm > 0
        data_weights[mask, :] /= norm[mask, None]

        wedge = data_weights.dot(data)
        if covariance is None:
            return self.r, wedge
        wedge_cov = data_weights.dot(covariance).dot(data_weights.T)
        return self.r, wedge, wedge_cov
