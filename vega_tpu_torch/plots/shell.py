"""Fixed-r angular shells. A copy of vega_tpu/plots/shell.py."""

from __future__ import annotations

import numpy as np

from .wedges import bin_centers


class Shell:
    """Compress a 2D correlation into angular shells at fixed r
    (reference: plots/shell.py:4-110)."""

    get_bin_centers = staticmethod(bin_centers)

    def __init__(self, rp=(0, 200, 50), rt=(0, 200, 50), angle_var='theta',
                 angle_range=(0, np.pi / 2), num_bins_fraction=50,
                 r=(30, 45), scaling=10, abs_mu=False):
        assert angle_var in ['theta', 'mu', 'mu2'], \
            "angle_var must be from ['theta', 'mu', 'mu2']"
        if angle_var != 'theta':
            angle_range = (angle_range[0], min(angle_range[1], 1))

        rp_centers = bin_centers(
            np.linspace(rp[0], rp[1], scaling * rp[2] + 1))
        rt_centers = bin_centers(
            np.linspace(rt[0], rt[1], scaling * rt[2] + 1))
        rt_mesh, rp_mesh = np.meshgrid(rt_centers, rp_centers)
        r_mesh = np.sqrt(rp_mesh ** 2 + rt_mesh ** 2)
        mu_mesh = rp_mesh / r_mesh

        if abs_mu:
            mu_mesh = np.abs(mu_mesh)
            mu2_mesh = mu_mesh ** 2
        else:
            mu2_mesh = mu_mesh ** 2
            mu2_mesh[mu_mesh < 0] *= -1
        theta_mesh = np.arccos(mu_mesh)

        rp_bins = np.linspace(rp[0], rp[1], rp[2] + 1)
        rt_bins = np.linspace(rt[0], rt[1], rt[2] + 1)
        rt_idx = np.digitize(rt_mesh, rt_bins) - 1
        rp_idx = np.digitize(rp_mesh, rp_bins) - 1

        rp_c = rp[0] + (rp_idx + 0.5) * (rp[1] - rp[0]) / rp[2]
        rt_c = rt[0] + (rt_idx + 0.5) * (rt[1] - rt[0]) / rt[2]
        r_c = np.sqrt(rp_c ** 2 + rt_c ** 2)
        mu_c = rp_c / r_c
        mu2_c = mu_c ** 2
        theta_c = np.arccos(mu_c)

        mesh = (mu_mesh if angle_var == 'mu'
                else mu2_mesh if angle_var == 'mu2' else theta_mesh)
        angle_c = (mu_c if angle_var == 'mu'
                   else mu2_c if angle_var == 'mu2' else theta_c)

        mask = (r_mesh >= r[0]) & (r_mesh <= r[1])
        mask &= (angle_c > angle_range[0]) & (angle_c < angle_range[1])

        num_bins_angle = int(np.ceil(np.sum(mask) / num_bins_fraction))
        angle_idx = ((mesh - angle_range[0])
                     / (angle_range[1] - angle_range[0])
                     * num_bins_angle).astype(int)

        bins = rt_idx + rt[2] * rp_idx + rt[2] * rp[2] * angle_idx
        counts = np.bincount(bins[mask].flatten())
        positive_idx = np.where(counts != 0)
        self.weights = np.zeros((num_bins_angle, rt[2] * rp[2]))
        weights_idx = np.unravel_index(positive_idx, self.weights.shape)
        self.weights[weights_idx] = counts[positive_idx]

        angle_bins = np.linspace(angle_range[0], angle_range[1],
                                 num_bins_angle + 1)
        self.angle = bin_centers(angle_bins)
        if angle_var == 'theta':
            self.angle = self.angle * (180 / np.pi)

    def __call__(self, data, covariance=None):
        """(reference: plots/shell.py:112-146)"""
        if covariance is None:
            cov_weight = np.ones(len(data))
        else:
            cov_weight = 1 / np.diagonal(covariance)

        norm = self.weights.dot(cov_weight)
        data_weights = self.weights * cov_weight
        mask = norm > 0
        data_weights[mask, :] /= norm[mask, None]

        shell = data_weights.dot(data)
        if covariance is None:
            return self.angle, shell
        shell_cov = data_weights.dot(covariance).dot(data_weights.T)
        return self.angle, shell, shell_cov
